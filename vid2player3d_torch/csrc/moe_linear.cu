// K2: the blended-expert linear layer of the MVAE decoder,
//
//     out[b, o] = sum_e coeff[b, e] * (sum_i x[b, i] * W[e, i, o] + bias[e, o])
//
// Replaces the Pallas TPU kernel `_moe_linear` / `_moe_kernel` of
// vid2player3d_tpu/ops/moe_linear.py. Like the TPU kernel it accumulates in
// f32 and writes neither a (B, E, out) per-expert buffer nor a per-sample
// blended weight: each output element is written once.
//
// Bound: f32 operations. At the decoder's full width (B = 10,240 envs, E = 6,
// (in, out) = (320, 256), (288, 256), (288, 290)) one decode does
// 2*6*10,240*(320*256 + 288*256 + 288*290) = 29.4 GFLOP against ~76 MB of
// bytes: 0.44 ms at the H100 SXM's 67 TFLOP/s outside the tensor cores,
// against 23 us for the bytes. TF32 or bf16 tensor cores would change the
// numerics and are left out.
//
// Design: a register-tiled f32 product over the concatenated (expert, in)
// reduction axis. A block of 256 threads owns a 128-row x 128-column output
// tile; each thread owns an 8 x 8 sub-tile held in one register accumulator.
// The block walks the E * in reduction in chunks of 8: each chunk stages
// coeff[b, e] * x[b, i] (the blend folded into the staged x tile, so the one
// accumulator sums sum_e coeff * (x @ W[e]) directly) transposed into shared
// memory beside the W[e] chunk; the next chunk is fetched into registers
// while the current one is multiplied (two shared buffers, one barrier per
// chunk). Each thread reads its 8 rows and 8 columns as two float4 halves
// 64 apart, so a warp's shared loads are broadcast or conflict-free. The
// bias blend sum_e coeff * bias is added last. Rows, columns and `in` need
// not be multiples of the tile: loads past an edge read zero and stores
// past an edge are skipped.
//
// The products use explicit fmaf (the library is built with -fmad=false for
// the elementwise kernels, which must not contract; here contraction is
// wanted, as in any f32 GEMM). The result therefore differs from the plain
// PyTorch version (cuBLAS, with the coefficient applied after the product)
// by float rounding only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // rows (batch) per block
constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 8;        // reduction values per shared-memory chunk
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each

struct Chunk {
  float x[4];   // this thread's share of the scaled x chunk
  float w[4];   // this thread's share of the W chunk
};

// Fetch reduction chunk `c` (expert e = c / kpe, in-offset (c % kpe) * kBK)
// into registers: x rows `xr` at in-offsets `xk .. xk+3`, scaled by
// coeff[row, e]; W row `wk` at columns `wc .. wc+3`.
__device__ __forceinline__ Chunk fetch(const float* __restrict__ x,
                                       const float* __restrict__ coeff,
                                       const float* __restrict__ w, int c, int kpe,
                                       int batch, int d_in, int d_out, int experts, int xr,
                                       int xk, int wk, int wc) {
  Chunk ch;
  const int e = c / kpe;
  const int k0 = (c % kpe) * kBK;
  const bool row_ok = xr < batch;
  const float s = row_ok ? coeff[(int64_t)xr * experts + e] : 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + xk + j;
    ch.x[j] = (row_ok && k < d_in) ? s * x[(int64_t)xr * d_in + k] : 0.0f;
  }
  const int kw = k0 + wk;
  const float* we = w + ((int64_t)e * d_in + kw) * d_out;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wc + j;
    ch.w[j] = (kw < d_in && col < d_out) ? we[col] : 0.0f;
  }
  return ch;
}

__global__ void __launch_bounds__(kThreads)
moe_linear_kernel(const float* __restrict__ x, const float* __restrict__ coeff,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ out, int batch, int d_in, int d_out, int experts) {
  __shared__ __align__(16) float xs[2][kBK][kBM];   // coeff * x, transposed
  __shared__ __align__(16) float ws[2][kBK][kBN];   // W[e] chunk

  const int tid = threadIdx.x;
  const int ty = tid / 16;            // rows ty*4 .. +3 and 64 + ty*4 .. +3
  const int tx = tid % 16;            // cols tx*4 .. +3 and 64 + tx*4 .. +3
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  // staging coordinates: x as 128 rows x 2 quads of the chunk, W as 8 rows x
  // 32 quads of columns
  const int xr = tid / 2, xk = (tid % 2) * 4;
  const int wk = tid / 32, wc = (tid % 32) * 4;
  const int kpe = d_in > 0 ? (d_in + kBK - 1) / kBK : 1;   // chunks per expert
  const int chunks = experts * kpe;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  Chunk next = fetch(x, coeff, w, 0, kpe, batch, d_in, d_out, experts, row0 + xr, xk, wk,
                     col0 + wc);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[buf][xk + j][xr] = next.x[j];
    *reinterpret_cast<float4*>(&ws[buf][wk][wc]) =
        make_float4(next.w[0], next.w[1], next.w[2], next.w[3]);
    __syncthreads();
    if (c + 1 < chunks)
      next = fetch(x, coeff, w, c + 1, kpe, batch, d_in, d_out, experts, row0 + xr, xk, wk,
                   col0 + wc);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the next iteration writes the other buffer; the one after writes this
    // buffer again only after its barrier, which every thread reaches after
    // finishing this chunk's reads
  }

  // bias blend, then the single write of the output tile
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= batch) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int go = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (go >= d_out) continue;
      float bsum = 0.0f;
      for (int e = 0; e < experts; ++e)
        bsum = fmaf(coeff[(int64_t)gr * experts + e], bias[(int64_t)e * d_out + go], bsum);
      out[(int64_t)gr * d_out + go] = acc[i][j] + bsum;
    }
  }
}

}  // namespace

extern "C" {

// out (batch, d_out) = sum_e coeff[:, e] * (x @ w[e] + bias[e]); all f32,
// row-major and contiguous: x (batch, d_in), coeff (batch, experts),
// w (experts, d_in, d_out), bias (experts, d_out). Returns the cudaError_t of
// the launch (0 = cudaSuccess).
int moe_linear_f32(const float* x, const float* coeff, const float* w, const float* bias,
                   float* out, int batch, int d_in, int d_out, int experts, void* stream) {
  if (batch <= 0 || d_out <= 0) return 0;
  const dim3 grid((unsigned)((d_out + kBN - 1) / kBN), (unsigned)((batch + kBM - 1) / kBM));
  moe_linear_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, coeff, w, bias, out, batch, d_in, d_out, experts);
  return (int)cudaGetLastError();
}

}  // extern "C"
