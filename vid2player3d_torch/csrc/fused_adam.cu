// K1: fused clip + Adam + apply, one in-place pass per parameter leaf.
//
// Replaces the Pallas TPU kernel `_leaf_pallas` / `_kernel` of
// vid2player3d_tpu/ops/fused_adam.py (driven there by
// `fused_clip_adam_apply`). Per element, in f32 arithmetic:
//
//     g' = clip * g
//     m  = b1 * m + (1 - b1) * g'
//     v  = b2 * v + (1 - b2) * g' * g'
//     p  = p - lr * (m / c1) / (sqrt(v / c2) + eps)
//
// p and g are f32; the moments m, v are f32 or bf16 (converted by intrinsics,
// round-to-nearest-even on store). p, m, v are updated in place, as the
// Pallas kernel aliased them. The four scalars [clip, lr, c1, c2] are read
// from DEVICE memory: they come from the global-norm pass on the card, and
// passing them as host floats would cost a host sync per optimizer step.
//
// Bound: HBM bytes. Each element reads p, g, m, v and writes p, m, v:
// 20 B/param with bf16 moments, 28 B/param with f32 moments, and ~15 flops,
// far below the card's compute rate. At ImitatorNet's 4,693,068 params one
// optimizer step moves 93.9 MB (bf16) / 131.4 MB (f32): ~28 us / ~39 us at an
// H100 SXM's 3.35 TB/s. The working set is just above the 50 MB L2, so the
// design is a plain grid-stride elementwise pass with coalesced accesses and
// nothing kept between blocks; one launch per leaf.
//
// Build with -fmad=false: the plain PyTorch version rounds every product and
// sum separately, and so does this kernel, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* x, int64_t i) { return x[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void store_f32(float* x, int64_t i, float v) { x[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* x, int64_t i, float v) {
  x[i] = __float2bfloat16_rn(v);
}

template <typename M>
__global__ void fused_clip_adam_kernel(float* __restrict__ p, M* __restrict__ m,
                                       M* __restrict__ v, const float* __restrict__ g,
                                       const float* __restrict__ scalars, int64_t n,
                                       float b1, float b2, float one_minus_b1,
                                       float one_minus_b2, float eps) {
  const float clip = scalars[0];
  const float lr = scalars[1];
  const float c1 = scalars[2];
  const float c2 = scalars[3];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float gi = g[i] * clip;
    const float mi = b1 * load_f32(m, i) + one_minus_b1 * gi;
    const float vi = b2 * load_f32(v, i) + one_minus_b2 * gi * gi;
    const float step = (mi / c1) / (sqrtf(vi / c2) + eps);
    p[i] = p[i] - lr * step;
    store_f32(m, i, mi);
    store_f32(v, i, vi);
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM on an H100

template <typename M>
int launch(float* p, M* m, M* v, const float* g, const float* scalars, int64_t n,
           float b1, float b2, float one_minus_b1, float one_minus_b2, float eps,
           void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_clip_adam_kernel<M><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, m, v, g, scalars, n, b1, b2, one_minus_b1, one_minus_b2, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess).
int fused_clip_adam_f32(float* p, float* m, float* v, const float* g,
                        const float* scalars, int64_t n, float b1, float b2,
                        float one_minus_b1, float one_minus_b2, float eps, void* stream) {
  return launch<float>(p, m, v, g, scalars, n, b1, b2, one_minus_b1, one_minus_b2, eps,
                       stream);
}

int fused_clip_adam_bf16(float* p, void* m, void* v, const float* g,
                         const float* scalars, int64_t n, float b1, float b2,
                         float one_minus_b1, float one_minus_b2, float eps, void* stream) {
  return launch<__nv_bfloat16>(p, (__nv_bfloat16*)m, (__nv_bfloat16*)v, g, scalars, n, b1,
                               b2, one_minus_b1, one_minus_b2, eps, stream);
}

}  // extern "C"
