// K3: world forward kinematics over a static joint tree, one env per thread.
//
//     R_0 = rot_0,                 p_0 = root
//     R_j = R_parent(j) @ rot_j,   p_j = p_parent(j) + R_parent(j) @ off_j
//
// Replaces the Pallas TPU kernel `_fk_pallas` (wrapped by `fk_chain`) of
// vid2player3d_tpu/ops/fk.py. The TPU kernel laid the env axis on the
// vector lanes (env-minor transposes around the call); here each thread walks
// the whole chain of its own env in the natural (N, J, 3, 3) layout, so no
// transpose is needed on either side.
//
// Bound: device-memory bytes. Per env it reads rot (J*9), off (J*3) and root
// (3) floats and writes pos (J*3) and rotmat (J*9): at J = 24 that is 2,316
// bytes, 23.7 MB at N = 10,240 envs, ~7 us at the H100 SXM's 3.35 TB/s; the
// ~1.5 kFLOP per env are negligible. The parent table travels in the kernel's
// argument block (the host checks parents[j] < j), and each thread reads its
// parent's world pose back from the output it has already written (L1-hot).
//
// Arithmetic: the same products and sums in the same order as the plain
// PyTorch version (`ops/fk.py` `_fk_plain` over `physics/soa.py`): each row
// is ((m0*v0 + m1*v1) + m2*v2). The library is built with -fmad=false, so no
// product is fused into a sum and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxJoints = 32;
constexpr int kThreads = 128;

struct Parents {
  int p[kMaxJoints];
};

__global__ void __launch_bounds__(kThreads)
fk_chain_kernel(const float* __restrict__ rot, const float* __restrict__ off,
                const float* __restrict__ root, float* pos, float* rm, int n, int joints,
                Parents parents) {
  const int64_t env = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  const float* r_env = rot + env * joints * 9;
  const float* o_env = off + env * joints * 3;
  float* p_env = pos + env * joints * 3;
  float* m_env = rm + env * joints * 9;

#pragma unroll
  for (int i = 0; i < 9; ++i) m_env[i] = r_env[i];
#pragma unroll
  for (int a = 0; a < 3; ++a) p_env[a] = root[env * 3 + a];

  for (int j = 1; j < joints; ++j) {
    const int par = parents.p[j];
    float Rp[9], pp[3], o[3], rj[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) Rp[i] = m_env[par * 9 + i];
#pragma unroll
    for (int a = 0; a < 3; ++a) pp[a] = p_env[par * 3 + a];
#pragma unroll
    for (int a = 0; a < 3; ++a) o[a] = o_env[j * 3 + a];
#pragma unroll
    for (int i = 0; i < 9; ++i) rj[i] = r_env[j * 9 + i];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float mv = Rp[a * 3 + 0] * o[0] + Rp[a * 3 + 1] * o[1] + Rp[a * 3 + 2] * o[2];
      p_env[j * 3 + a] = pp[a] + mv;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        m_env[j * 9 + a * 3 + b] = Rp[a * 3 + 0] * rj[0 * 3 + b] + Rp[a * 3 + 1] * rj[1 * 3 + b]
                                   + Rp[a * 3 + 2] * rj[2 * 3 + b];
    }
  }
}

}  // namespace

extern "C" {

// pos (n, joints, 3) and rm (n, joints, 3, 3) from rot (n, joints, 3, 3),
// off (n, joints, 3) and root (n, 3), all f32 and contiguous. `parents` is a
// host array of `joints` ints with parents[j] < j for j >= 1. Returns the
// cudaError_t of the launch (0 = cudaSuccess), or cudaErrorInvalidValue for
// a tree the kernel does not take.
int fk_chain_f32(const float* rot, const float* off, const float* root, float* pos, float* rm,
                 int n, int joints, const int* parents, void* stream) {
  if (joints < 1 || joints > kMaxJoints) return (int)cudaErrorInvalidValue;
  Parents par = {};
  for (int j = 1; j < joints; ++j) {
    if (parents[j] < 0 || parents[j] >= j) return (int)cudaErrorInvalidValue;
    par.p[j] = parents[j];
  }
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fk_chain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(rot, off, root, pos, rm, n,
                                                                 joints, par);
  return (int)cudaGetLastError();
}

}  // extern "C"
