// K1: the whole clip + Adam + apply step over every parameter leaf, in two
// launches: a multi-tensor global-norm reduction that writes the step's
// scalars, then one multi-tensor update.
//
// Replaces the Pallas TPU kernel `_leaf_pallas` / `_kernel` of
// vid2player3d_tpu/ops/fused_adam.py (driven there by
// `fused_clip_adam_apply`, whose global norm is plain jnp). Per element, in
// f32 arithmetic:
//
//     g' = clip * g
//     m  = b1 * m + (1 - b1) * g'
//     v  = b2 * v + (1 - b2) * g' * g'
//     p  = p - lr * (m / c1) / (sqrt(v / c2) + eps)
//
// p and g are f32; the moments m, v are f32 or bf16 (a template parameter,
// converted by intrinsics, round-to-nearest-even on store). p, m, v are
// updated in place, as the Pallas kernel aliased them.
//
// The leaves ride in the kernel's argument block: a table of (p, m, v, g, n)
// for up to kCapacity leaves, passed by value as a __grid_constant__ struct,
// so nothing is copied to the device per step. Above the capacity the host
// side chunks the leaves into several launches (and reports each one). Each
// block takes one tile of kTile elements of one leaf; a leaf whose four
// base addresses allow it is read and written with 16-byte vectors (8-byte
// for bf16 moments), the rest of it element by element.
//
// The norm kernel reduces sum(g*g) over all leaves in f64 and writes
// [clip, lr, c1, c2] and the incremented step count to device memory, where
// the update reads them (no host sync per step; lr is read through a pointer
// because the learner adapts it on the device). It is deterministic: every
// block writes its partial sum to a fixed slot, and the last block to finish
// (a fence and a counter) adds the slots in a fixed order.
//
// Bound: HBM bytes. The update reads p, g, m, v and writes p, m, v: 20 B per
// param with bf16 moments, 28 B with f32 moments; the norm reads g once more
// (4 B). At ImitatorNet's 4,693,068 params: 93.9 MB (update, bf16 moments)
// + 18.8 MB (norm) = 112.6 MB per step, 0.0336 ms at an H100 SXM's 3.35 TB/s.
//
// Build with -fmad=false: the plain PyTorch version rounds every product and
// sum separately, and so does the update, so the two agree bit for bit given
// the same scalars.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCapacity = 64;              // leaves per launch
constexpr int kThreads = 256;
constexpr int kVec = 4;                    // elements per vector access
constexpr int kUnroll = 4;                 // vectors per thread per tile
constexpr int kTile = kThreads * kVec * kUnroll;   // 4096 elements per block
constexpr int kNormBlocks = 1056;          // 8 of 256 threads per SM of an H100: a full wave

struct LeafTable {
  float* p[kCapacity];
  void* m[kCapacity];
  void* v[kCapacity];
  const float* g[kCapacity];
  int64_t n[kCapacity];
  int tile_start[kCapacity + 1];           // prefix sum of tiles per leaf
  int count;
};

struct Scalars {
  float clip, lr, c1, c2;
};

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps;
};

// the leaf that owns `tile`: the last l with tile_start[l] <= tile
__device__ __forceinline__ int leaf_of(const LeafTable& t, int tile) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned(const void* ptr, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float load1(const float* x, int64_t i) { return x[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void store1(float* x, int64_t i, float v) { x[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* x, int64_t i, float v) {
  x[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load4(const float* x, int64_t i, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(x + i);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* x, int64_t i, float (&o)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(x + i);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  o[0] = __low2float(a); o[1] = __high2float(a); o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* x, int64_t i, const float (&o)[4]) {
  *reinterpret_cast<float4*>(x + i) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* x, int64_t i, const float (&o)[4]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(o[0], o[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(x + i) = q;
}

// the plain version's operations in its order
__device__ __forceinline__ void adam(float& p, float& m, float& v, float g, const Scalars& s,
                                     const Hyper& h) {
  const float gi = g * s.clip;
  m = h.b1 * m + h.one_minus_b1 * gi;
  v = h.b2 * v + h.one_minus_b2 * gi * gi;
  const float step = (m / s.c1) / (sqrtf(v / s.c2) + h.eps);
  p = p - s.lr * step;
}

template <typename M>
__device__ __forceinline__ void adam_at(float* p, M* m, M* v, const float* g, int64_t i,
                                        const Scalars& s, const Hyper& h) {
  float pi = p[i], mi = load1(m, i), vi = load1(v, i);
  adam(pi, mi, vi, g[i], s, h);
  p[i] = pi;
  store1(m, i, mi);
  store1(v, i, vi);
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ LeafTable t, const float* __restrict__ scalars,
                   Hyper h) {
  const int l = leaf_of(t, blockIdx.x);
  const int64_t n = t.n[l];
  const int64_t base = (int64_t)(blockIdx.x - t.tile_start[l]) * kTile;
  const int64_t end = base + kTile < n ? base + kTile : n;
  float* __restrict__ p = t.p[l];
  M* __restrict__ m = static_cast<M*>(t.m[l]);
  M* __restrict__ v = static_cast<M*>(t.v[l]);
  const float* __restrict__ g = t.g[l];
  const Scalars s{scalars[0], scalars[1], scalars[2], scalars[3]};

  if (aligned(p, 16) && aligned(g, 16) && aligned(m, kVec * sizeof(M)) &&
      aligned(v, kVec * sizeof(M))) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + ((int64_t)j * kThreads + threadIdx.x) * kVec;
      if (i + kVec <= end) {
        float pv[4], mv[4], vv[4], gv[4];
        load4(p, i, pv);
        load4(m, i, mv);
        load4(v, i, vv);
        load4(g, i, gv);
#pragma unroll
        for (int k = 0; k < 4; ++k) adam(pv[k], mv[k], vv[k], gv[k], s, h);
        store4(p, i, pv);
        store4(m, i, mv);
        store4(v, i, vv);
      } else {
        for (int64_t k = i; k < end; ++k) adam_at(p, m, v, g, k, s, h);
      }
    }
  } else {
    for (int64_t i = base + threadIdx.x; i < end; i += kThreads) adam_at(p, m, v, g, i, s, h);
  }
}

// fixed-order sum over the block: warp trees, then warp 0 over the warps
__device__ __forceinline__ double block_sum(double x, double* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += smem[w];
  __syncthreads();
  return total;   // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
adam_norm_kernel(const __grid_constant__ LeafTable t, int tiles, double* partials,
                 int partial_base, int partials_total, unsigned* counter, int finalize,
                 const int* count_in, int* count_out, const float* lr_ptr, float lr_value,
                 float max_norm, float b1, float b2, float* scalars) {
  __shared__ double smem[kThreads / 32];
  __shared__ bool last;
  double acc = 0.0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int l = leaf_of(t, tile);
    const int64_t n = t.n[l];
    const int64_t base = (int64_t)(tile - t.tile_start[l]) * kTile;
    const int64_t end = base + kTile < n ? base + kTile : n;
    const float* __restrict__ g = t.g[l];
    if (aligned(g, 16)) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = base + ((int64_t)j * kThreads + threadIdx.x) * kVec;
        if (i + kVec <= end) {
          float gv[4];
          load4(g, i, gv);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc += (double)gv[k] * (double)gv[k];
        } else {
          for (int64_t k = i; k < end; ++k) acc += (double)g[k] * (double)g[k];
        }
      }
    } else {
      for (int64_t i = base + threadIdx.x; i < end; i += kThreads)
        acc += (double)g[i] * (double)g[i];
    }
  }
  const double mine = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[partial_base + blockIdx.x] = mine;
  if (!finalize) return;

  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int i = threadIdx.x; i < partials_total; i += kThreads) s += __ldcg(partials + i);
  const double total = block_sum(s, smem);
  if (threadIdx.x == 0) {
    const float gnorm = sqrtf((float)total);
    const float clip = fminf(max_norm / fmaxf(gnorm, 1e-12f), 1.0f);
    const int count = *count_in + 1;
    const float c = (float)count;
    *count_out = count;
    scalars[0] = clip;
    scalars[1] = lr_ptr != nullptr ? *lr_ptr : lr_value;
    scalars[2] = 1.0f - powf(b1, c);
    scalars[3] = 1.0f - powf(b2, c);
    *counter = 0u;   // ready for the next step
  }
}

// Host rows are int64 [p, m, v, g, n] per leaf. Fills the table for leaves
// [first, first + count) and returns its number of tiles.
int fill_table(const int64_t* rows, int first, int count, LeafTable* t) {
  t->count = count;
  int tiles = 0;
  for (int j = 0; j < count; ++j) {
    const int64_t* r = rows + 5 * (int64_t)(first + j);
    t->p[j] = reinterpret_cast<float*>(r[0]);
    t->m[j] = reinterpret_cast<void*>(r[1]);
    t->v[j] = reinterpret_cast<void*>(r[2]);
    t->g[j] = reinterpret_cast<const float*>(r[3]);
    t->n[j] = r[4];
    t->tile_start[j] = tiles;
    tiles += (int)((r[4] + kTile - 1) / kTile);
  }
  t->tile_start[count] = tiles;
  return tiles;
}

template <typename M>
int update(const int64_t* rows, int n_leaves, const float* scalars, float b1, float b2,
           float one_minus_b1, float one_minus_b2, float eps, void* stream, int* launches) {
  *launches = 0;
  const Hyper h{b1, b2, one_minus_b1, one_minus_b2, eps};
  for (int first = 0; first < n_leaves; first += kCapacity) {
    LeafTable t;
    const int count = n_leaves - first < kCapacity ? n_leaves - first : kCapacity;
    const int tiles = fill_table(rows, first, count, &t);
    if (tiles == 0) continue;
    adam_update_kernel<M><<<tiles, kThreads, 0, (cudaStream_t)stream>>>(t, scalars, h);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++*launches;
  }
  return 0;
}

}  // namespace

extern "C" {

int fused_adam_capacity() { return kCapacity; }
int fused_adam_norm_blocks() { return kNormBlocks; }

// The global norm of the grads (column g of `rows`), then [clip, lr, c1, c2]
// into `scalars` and count_in + 1 into `count_out`. `partials` holds at least
// fused_adam_norm_blocks() doubles per chunk of fused_adam_capacity()
// leaves; `counter` is one zeroed unsigned that the kernel leaves zeroed.
// lr is read from `lr_ptr` when it is not null, else it is `lr_value`.
// Returns the cudaError_t (0 = cudaSuccess); the launches in `*launches`.
int fused_adam_norm(const int64_t* rows, int n_leaves, double* partials, unsigned* counter,
                    const int* count_in, int* count_out, const float* lr_ptr, float lr_value,
                    float max_norm, float b1, float b2, float* scalars, void* stream,
                    int* launches) {
  *launches = 0;
  const int chunks = n_leaves > 0 ? (n_leaves + kCapacity - 1) / kCapacity : 1;
  int grids[(1 << 16) / kCapacity];
  if (chunks > (int)(sizeof(grids) / sizeof(grids[0]))) return (int)cudaErrorInvalidValue;
  LeafTable t;
  int total = 0;
  for (int c = 0; c < chunks; ++c) {
    const int first = c * kCapacity;
    const int count = n_leaves - first < kCapacity ? n_leaves - first : kCapacity;
    const int tiles = count > 0 ? fill_table(rows, first, count, &t) : 0;
    grids[c] = tiles < 1 ? 1 : (tiles < kNormBlocks ? tiles : kNormBlocks);
    total += grids[c];
  }
  int base = 0;
  for (int c = 0; c < chunks; ++c) {
    const int first = c * kCapacity;
    const int count = n_leaves - first < kCapacity ? n_leaves - first : kCapacity;
    int tiles = 0;
    if (count > 0) {
      tiles = fill_table(rows, first, count, &t);
    } else {
      t.count = 1;     // no leaves: one block writes a zero sum
      t.n[0] = 0;
      t.g[0] = nullptr;
      t.tile_start[0] = t.tile_start[1] = 0;
    }
    adam_norm_kernel<<<grids[c], kThreads, 0, (cudaStream_t)stream>>>(
        t, tiles, partials, base, total, counter, c == chunks - 1, count_in, count_out, lr_ptr,
        lr_value, max_norm, b1, b2, scalars);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++*launches;
    base += grids[c];
  }
  return 0;
}

// The update over every leaf of `rows` with the device scalars
// [clip, lr, c1, c2]. Returns the cudaError_t; the launches in `*launches`.
int fused_adam_update_f32(const int64_t* rows, int n_leaves, const float* scalars, float b1,
                          float b2, float one_minus_b1, float one_minus_b2, float eps,
                          void* stream, int* launches) {
  return update<float>(rows, n_leaves, scalars, b1, b2, one_minus_b1, one_minus_b2, eps, stream,
                       launches);
}

int fused_adam_update_bf16(const int64_t* rows, int n_leaves, const float* scalars, float b1,
                           float b2, float one_minus_b1, float one_minus_b2, float eps,
                           void* stream, int* launches) {
  return update<__nv_bfloat16>(rows, n_leaves, scalars, b1, b2, one_minus_b1, one_minus_b2, eps,
                               stream, launches);
}

}  // extern "C"
