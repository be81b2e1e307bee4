// K2: the blended-expert linear layer of the MVAE decoder,
//
//     out[b, o] = sum_e coeff[b, e] * (sum_i x[b, i] * W[e, i, o] + bias[e, o])
//
// Replaces the Pallas TPU kernel `_moe_linear` / `_moe_kernel` of
// vid2player3d_tpu/ops/moe_linear.py. Like the TPU kernel it accumulates in
// f32 and writes neither a (B, E, out) per-expert buffer nor a per-sample
// blended weight: each output element is written once.
//
// One GEMM. The blend folds into the A operand, A'[b, e*in + i] =
// coeff[b, e] * x[b, i], and B' is W stacked over the experts, so the
// reduction runs over K = E * in (1,920 or 1,728 in the decoder). The bias
// blend sum_e coeff * bias is one more K tile, A = coeff and B = bias^T, so
// the epilogue only stores (a blend there took a third of the kernel's time).
//
// Numerics: the 3xTF32 split. Each operand is split a = a_hi + a_lo with
// a_hi = cvt.rna.tf32(a) and a_lo = cvt.rna.tf32(a - a_hi), and one f32
// accumulator sums A_lo*B_hi + A_hi*B_lo + A_hi*B_hi (small terms first).
// The dropped A_lo*B_lo is 2^-22 of each product; the tensor cores' f32
// sums, which do not round each addition as IEEE f32 does, leave about 1e-5
// of the output's size at K = 1,920 (measured against the f32 plain version
// on an H100): f32-grade, not TF32-grade (2^-11).
//
// Bound: tensor-core operations. At B = 10,240 the decoder's three layers
// ((in, out) = (320, 256), (288, 256), (288, 290), E = 6) are 29.4 GFLOP,
// three passes 88.2 GFLOP: 0.178 ms at the H100 SXM's 495 TFLOP/s dense TF32,
// against 23 us for the bytes.
//
// Design for Hopper:
// - `wgmma.mma_async m64nNk8 .f32.tf32.tf32`, A from registers (it has to pass
//   through them anyway, to be scaled by coeff and split), B from shared
//   memory. TF32 wgmma takes K-major operands only, so a prep kernel
//   (launched once per call) writes W_hi^T and W_lo^T as (E + 1, out, in4),
//   slot E holding bias^T; in4 = max(in, E) rounded up to 4 floats, so that
//   every TMA row stride is a multiple of 16 bytes. The wrapper allocates
//   both and keeps nothing between calls.
// - TMA loads x (B, in4) and both W^T halves into a ring of kStages shared
//   stages behind `mbarrier`s, K tiles of 32 floats (128 B) with the 128-byte
//   swizzle. One thread of a producer warpgroup issues them; the producer
//   hands its registers to the three consumer warpgroups (`setmaxnreg`), each
//   of which owns 64 rows of the 192-row tile and keeps 152 registers for
//   its accumulator and both halves of its A fragments. A K tile never
//   straddles two experts: each expert's `in` is walked in ceil(in4 / 32)
//   tiles, TMA's zero fill covering the ragged end, so one coefficient
//   column scales the whole tile. The same zero fill covers the ragged M and
//   N tiles.
// - Tiles: 192 rows x BN columns, BN = 128 (out = 256: two N tiles) or 152
//   (out = 290: two N tiles, 5% padding). At B = 10,240 every layer is
//   54 x 2 = 108 CTAs, one CTA per SM: one resident wave on 132 SMs.
// - The output rows of the 290-wide layer are 1,160 B, no multiple of 16, so
//   the epilogue writes with predicated 8-byte stores, not a TMA store.
// - Keeping one wgmma batch in flight while the next A fragments are split
//   (two register sets) and a fourth stage were both measured no faster.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kBM = 192;                 // rows per CTA: 3 warpgroups x 64
constexpr int kBK = 32;                  // floats per K tile (128 B)
constexpr int kStages = 3;
constexpr int kConsumers = 3;            // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + one producer warpgroup
// registers per thread after the producer hands its own to the consumers:
// 128 x 40 + 384 x 152 = 63,488 of the SM's 65,536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 152;
constexpr int kXBytes = kBM * kBK * 4;   // 24 KB

template <int BN>
struct Tile {
  static constexpr int kWBytes = BN * kBK * 4;            // one W half
  static constexpr int kStageBytes = kXBytes + 2 * kWBytes;
  // stages, then 2 * kStages barriers; +1 KB to align the base to 1024 B
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, rows of 128 B,
// 8-row groups 1,024 B apart
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps a register's value where the asynchronous wgmma reads or writes it
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n152(float (&d)[76], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75"
      "}, {%76, %77, %78, %79}, %80, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN>
struct Mma;
template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_n128(d, a, desc);
  }
};
template <>
struct Mma<152> {
  static __device__ __forceinline__ void run(float (&d)[76], const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_n152(d, a, desc);
  }
};

// W (E, in, out) and bias (E, out) -> W_hi^T, W_lo^T (E + 1, out, in4), the
// TF32 split of each weight: slots 0 .. E-1 hold W[e]^T, zero in the padding
// columns in <= i < in4; slot E holds bias^T in its first E columns, zero
// after them (the GEMM's bias tile). 32 x 32 tiles through shared memory, so
// both the reads and the writes are coalesced.
__global__ void __launch_bounds__(256)
moe_split_w_kernel(const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ hi_t, float* __restrict__ lo_t, int d_in, int d_in4,
                   int d_out, int experts) {
  __shared__ float tile[32][33];
  const int e = blockIdx.z, i0 = blockIdx.x * 32, o0 = blockIdx.y * 32;
  const float* we = w + (int64_t)e * d_in * d_out;
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int i = i0 + k, o = o0 + threadIdx.x;
    float v = 0.0f;
    if (o < d_out) {
      if (e < experts && i < d_in) v = we[(int64_t)i * d_out + o];
      if (e == experts && i < experts) v = bias[(int64_t)i * d_out + o];
    }
    tile[k][threadIdx.x] = v;
  }
  __syncthreads();
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int o = o0 + k, i = i0 + threadIdx.x;
    if (o < d_out && i < d_in4) {
      const float v = tile[threadIdx.x][k];
      const float h = tf32_rna(v);
      const int64_t at = ((int64_t)e * d_out + o) * d_in4 + i;
      hi_t[at] = h;
      lo_t[at] = tf32_rna(v - h);
    }
  }
}

// consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63; this thread
// holds rows ra and ra + 8 of the A fragments and of the accumulator
template <int BN>
__device__ __forceinline__ void consume(const uint8_t* smem, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ coeff, float* __restrict__ out,
                                        int batch, int d_out, int experts, int tiles_per_expert,
                                        int m0, int n0, int warp, int lane) {
  using T = Tile<BN>;
  const int x_tiles = experts * tiles_per_expert;
  const int tiles = x_tiles + (experts + kBK - 1) / kBK;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int ra = wg * 64 + (warp % 4) * 16 + g;
  const int row_a = m0 + ra, row_b = row_a + 8;
  const int swz = ra & 7;   // the 128-byte swizzle of rows ra and ra + 8
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < tiles; ++kt) {
    const int s = kt % kStages;
    const bool bias_tile = kt >= x_tiles;
    const int e = bias_tile ? 0 : kt / tiles_per_expert;
    const float ca = row_a < batch ? coeff[(int64_t)row_a * experts + e] : 0.0f;
    const float cb = row_b < batch ? coeff[(int64_t)row_b * experts + e] : 0.0f;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* st = smem + s * T::kStageBytes;
    const float* xs = reinterpret_cast<const float*>(st);

    // A fragments of the four k8 steps: a0 (ra, c), a1 (ra+8, c), a2 (ra, c+4),
    // a3 (ra+8, c+4), c = 8 ks + t. An x tile gives coeff[:, e] * x, with
    // x(r, c) in 16-byte chunk (c/4) ^ (r%8) of row r; a bias tile gives
    // coeff itself (its B is bias^T), so the bias blend is one more K tile
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float a[4];
      if (bias_tile) {
        const int c = (kt - x_tiles) * kBK + 8 * ks + t;
        const float* qa = coeff + (int64_t)row_a * experts;
        const float* qb = coeff + (int64_t)row_b * experts;
        a[0] = row_a < batch && c < experts ? qa[c] : 0.0f;
        a[1] = row_b < batch && c < experts ? qb[c] : 0.0f;
        a[2] = row_a < batch && c + 4 < experts ? qa[c + 4] : 0.0f;
        a[3] = row_b < batch && c + 4 < experts ? qb[c + 4] : 0.0f;
      } else {
        const int c0 = (((2 * ks) ^ swz) << 2) + t, c1 = (((2 * ks + 1) ^ swz) << 2) + t;
        a[0] = ca * xs[ra * kBK + c0];
        a[1] = cb * xs[(ra + 8) * kBK + c0];
        a[2] = ca * xs[ra * kBK + c1];
        a[3] = cb * xs[(ra + 8) * kBK + c1];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = tf32_rna(a[j]);
        hi[ks][j] = __float_as_uint(h);
        lo[ks][j] = __float_as_uint(tf32_rna(a[j] - h));
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    wgmma_fence();
    const uint64_t d_hi = smem_desc(st + kXBytes), d_lo = smem_desc(st + kXBytes + T::kWBytes);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // each k8 step is 32 bytes further along the swizzled 128-byte rows
      Mma<BN>::run(acc, lo[ks], d_hi + 2 * ks);
      Mma<BN>::run(acc, hi[ks], d_lo + 2 * ks);
      Mma<BN>::run(acc, hi[ks], d_hi + 2 * ks);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_reg(hi[ks][j]);
        fence_reg(lo[ks][j]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: one store per output, two columns at a time where they are
  // 8-byte aligned; acc[4j + 2h + q] is row ra + 8h, column 8j + 2t + q
  const bool pairs = (d_out % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row_b : row_a;
      if (row >= batch || col >= d_out) continue;
      float* o = out + (int64_t)row * d_out + col;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        o[0] = acc[4 * j + 2 * h];
        if (col + 1 < d_out) o[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
moe_linear_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap whi_map,
                  const __grid_constant__ CUtensorMap wlo_map, const float* __restrict__ coeff,
                  float* __restrict__ out, int batch, int d_out, int experts,
                  int tiles_per_expert) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int x_tiles = experts * tiles_per_expert;
  const int tiles = x_tiles + (experts + kBK - 1) / kBK;   // + the bias tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        uint8_t* st = smem + s * T::kStageBytes;
        if (kt < x_tiles) {
          const int e = kt / tiles_per_expert, k0 = (kt % tiles_per_expert) * kBK;
          mbar_expect_tx(&full[s], T::kStageBytes);
          tma_load_2d(st, &x_map, &full[s], k0, m0);
          tma_load_3d(st + kXBytes, &whi_map, &full[s], k0, n0, e);
          tma_load_3d(st + kXBytes + T::kWBytes, &wlo_map, &full[s], k0, n0, e);
        } else {
          // bias^T sits in slot `experts` of the split weights; no x
          const int k0 = (kt - x_tiles) * kBK;
          mbar_expect_tx(&full[s], 2 * T::kWBytes);
          tma_load_3d(st + kXBytes, &whi_map, &full[s], k0, n0, experts);
          tma_load_3d(st + kXBytes + T::kWBytes, &wlo_map, &full[s], k0, n0, experts);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<BN>(smem, full, empty, coeff, out, batch, d_out, experts, tiles_per_expert,
                m0, n0, warp, lane);
  }
}

// cuTensorMapEncodeTiled from libcuda, which the process has already loaded
// (no link against it)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrNoLibcuda = 900;  // libcuda or its cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 1000;    // + the CUresult of a refused tensor map
constexpr int kErrTile = 901;       // a tile width this library was not built for

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a row-major f32 tensor of `rank` dims (innermost first), 128-byte swizzled
// boxes, zero fill outside
int make_map(CUtensorMap* map, const float* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoLibcuda;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                         const_cast<float*>(base), dims, strides, box, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int BN>
int launch_main(const float* x, const float* coeff, const float* w_hi_t, const float* w_lo_t,
                float* out, int batch, int d_in4, int d_out, int experts, cudaStream_t stream) {
  CUtensorMap x_map, hi_map, lo_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)d_in4, (cuuint64_t)batch};
  const cuuint64_t x_strides[1] = {(cuuint64_t)d_in4 * 4};
  const cuuint32_t x_box[2] = {kBK, kBM};
  const cuuint64_t w_dims[3] = {(cuuint64_t)d_in4, (cuuint64_t)d_out, (cuuint64_t)experts + 1};
  const cuuint64_t w_strides[2] = {(cuuint64_t)d_in4 * 4, (cuuint64_t)d_in4 * d_out * 4};
  const cuuint32_t w_box[3] = {kBK, BN, 1};
  int err = make_map(&x_map, x, 2, x_dims, x_strides, x_box);
  if (err == 0) err = make_map(&hi_map, w_hi_t, 3, w_dims, w_strides, w_box);
  if (err == 0) err = make_map(&lo_map, w_lo_t, 3, w_dims, w_strides, w_box);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(moe_linear_kernel<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (err != 0) return err;
  const dim3 grid((unsigned)((d_out + BN - 1) / BN), (unsigned)((batch + kBM - 1) / kBM));
  moe_linear_kernel<BN><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(
      x_map, hi_map, lo_map, coeff, out, batch, d_out, experts, (d_in4 + kBK - 1) / kBK);
  return (int)cudaGetLastError();
}

template <int BN>
int occupancy() {
  int blocks = 0;
  if (cudaFuncSetAttribute(moe_linear_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Tile<BN>::kSmem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, moe_linear_kernel<BN>, kThreads,
                                                    Tile<BN>::kSmem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

// The tiling for tile width `bn` (128 or 152): [rows, columns, K floats,
// stages, threads, shared bytes per CTA, resident CTAs per SM]. Returns 0, or
// kErrTile for another width.
int moe_linear_tiling(int bn, int* info) {
  if (bn != 128 && bn != 152) return kErrTile;
  info[0] = kBM;
  info[1] = bn;
  info[2] = kBK;
  info[3] = kStages;
  info[4] = kThreads;
  info[5] = bn == 128 ? Tile<128>::kSmem : Tile<152>::kSmem;
  info[6] = bn == 128 ? occupancy<128>() : occupancy<152>();
  return 0;
}

// The prep kernel: w (experts, d_in, d_out) and bias (experts, d_out) ->
// w_hi_t, w_lo_t (experts + 1, d_out, d_in4), the TF32 split of each weight,
// transposed, zero in columns d_in .. d_in4 - 1, with bias^T in slot
// `experts` (d_in4 >= experts). Returns the cudaError_t of the launch
// (0 = cudaSuccess).
int moe_split_w_f32(const float* w, const float* bias, float* w_hi_t, float* w_lo_t, int d_in,
                    int d_in4, int d_out, int experts, void* stream) {
  if (experts <= 0 || d_in4 <= 0 || d_out <= 0) return 0;
  if (d_in4 < experts) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((d_in4 + 31) / 32), (unsigned)((d_out + 31) / 32),
                  (unsigned)experts + 1);
  moe_split_w_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      w, bias, w_hi_t, w_lo_t, d_in, d_in4, d_out, experts);
  return (int)cudaGetLastError();
}

// out (batch, d_out) = sum_e coeff[:, e] * (x @ w[e] + bias[e]); all f32,
// row-major and contiguous: x (batch, d_in4) with columns d_in .. d_in4 - 1
// zero and a 16-byte aligned base, coeff (batch, experts), w_hi_t and w_lo_t
// (experts + 1, d_out, d_in4) from moe_split_w_f32. `bn` is the tile width
// (128 or 152). Returns the cudaError_t of the launch (0 = cudaSuccess),
// kErrNoLibcuda, kErrTile, or kErrEncode + the CUresult of a refused tensor
// map.
int moe_linear_f32(const float* x, const float* coeff, const float* w_hi_t,
                   const float* w_lo_t, float* out, int batch, int d_in4, int d_out, int experts,
                   int bn, void* stream) {
  if (bn != 128 && bn != 152) return kErrTile;
  if (batch <= 0 || d_out <= 0 || experts <= 0 || d_in4 < experts)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bn == 128 ? launch_main<128>(x, coeff, w_hi_t, w_lo_t, out, batch, d_in4, d_out,
                                      experts, st)
                   : launch_main<152>(x, coeff, w_hi_t, w_lo_t, out, batch, d_in4, d_out,
                                      experts, st);
}

}  // extern "C"
