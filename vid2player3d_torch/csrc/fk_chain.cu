// K3: world forward kinematics over a static joint tree.
//
//     R_0 = rot_0,                 p_0 = root
//     R_j = R_parent(j) @ rot_j,   p_j = p_parent(j) + R_parent(j) @ off_j
//
// Replaces the Pallas TPU kernel `_fk_pallas` (wrapped by `fk_chain`) of
// vid2player3d_tpu/ops/fk.py. The TPU kernel laid the env axis on the
// vector lanes (env-minor transposes around the call); here the inputs and
// outputs keep the natural (N, J, 3, 3) / (N, J, 3) layout, and each CTA
// streams a run of consecutive envs through shared memory.
//
// Bound: device-memory bytes. Per env it reads rot (J*9), off (J*3) and root
// (3) floats and writes pos (J*3) and rotmat (J*9): at J = 24 that is 2,316
// bytes, 23.7 MB at N = 10,240 envs, ~7 us at the H100 SXM's 3.35 TB/s; the
// ~1.5 kFLOP per env are negligible.
//
// Design (one launch per call; the launch shape comes from `launch_shape` in
// ops/fk.py, which passes envs_per_cta and the shared-memory bytes):
//   - Every SM busy, evenly: about four CTAs of 96 threads per SM, each
//     owning a contiguous run of ceil(N / (4 * SMs)) envs (20 at N = 10,240:
//     80 per SM), so that four chains run on each SM at once.
//   - A CTA walks its run in chunks of 8 envs through a ring of 3 stages in
//     shared memory, so that chunk c is computed while chunks c+1 and c+2 are
//     on their way and chunk c-1's stores drain. An env's rot and off rows
//     are contiguous in device memory (864 and 288 bytes at J = 24): warp 2
//     copies each row with one TMA bulk copy (`cp.async.bulk`, completing on
//     the stage's `mbarrier`) into a row padded to a multiple of 4 floats
//     that is not one of 8 (220 and 76 at J = 24), and back out of a
//     double-buffered output slab with one bulk store per row. No thread
//     spends registers or instructions on the bytes. The root rows, and the
//     rot and off rows of a base that is not 16-byte aligned (a view at an
//     offset) or of a row that is no multiple of 16 bytes, go through 4-byte
//     `cp.async` copies and coalesced stores instead: one kernel for every
//     input, ragged runs and chunks included.
//   - Three lanes per env (warp 0), one per row a: lane a computes row a of
//     R_j and p_j[a] from row a of R_par and p_par[a], which it wrote itself,
//     so the chain needs no barrier and never touches device memory. When
//     the parent is the previous joint its row stays in registers. The
//     humanoid's 24-joint tree in MuJoCo body order (the tennis path's) has a
//     build of its own in which the chain is straight-line code: the parents
//     are constants, every row a later joint needs stays in a register (no
//     branch, no load of a parent), and the inputs come in 16-byte
//     shared-memory loads a block of 4 joints ahead. Other trees take a loop.
//     The padded rows put the 8 envs of a chunk on 8 different bank groups.
//
// Arithmetic: the same products and sums in the same order as the plain
// PyTorch version (`ops/fk.py` `_fk_plain` over `physics/soa.py`): each row
// is ((m0*v0 + m1*v1) + m2*v2). The library is built with -fmad=false, so no
// product is fused into a sum and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxJoints = 32;
constexpr int kChunk = 8;        // envs per ring stage, three lanes each
constexpr int kStages = 3;       // chunks in flight: two loading, one computed
constexpr int kOutSlots = 2;     // output slabs: one computed, one storing
constexpr int kThreads = 96;     // warp 0 computes, warp 2 moves rows
constexpr int kCtasPerSm = 4;    // as ops/fk.py launches them: registers for four
constexpr int kCopyWarp = 2;
constexpr int kMaxDevices = 64;
constexpr int kHumanoidJoints = 24;

// Parent of joint j >= 1 of the humanoid's 24-joint tree in MuJoCo body
// order, the tennis path's, which has a build of its own.
__host__ __device__ constexpr int mujoco_parent(int j) {
  constexpr int kMujoco[kHumanoidJoints] = {-1, 0,  1,  2,  3,  0,  5,  6,  7,  0,  9,  10,
                                            11, 12, 11, 14, 15, 16, 17, 11, 19, 20, 21, 22};
  return kMujoco[j];
}

struct Parents {
  int p[kMaxJoints];
};

// a row of `floats` padded to a multiple of 4 that is not one of 8
__host__ __device__ __forceinline__ int padded(int floats) {
  const int r = (floats + 3) & ~3;
  return (r & 7) ? r : r + 4;
}

// floats of one ring stage: a chunk's rot rows, off rows and root rows
__host__ __device__ __forceinline__ int stage_floats(int joints) {
  return kChunk * (padded(joints * 9) + padded(joints * 3) + 3);
}

// floats of one output slab: a chunk's rotmat rows and pos rows
__host__ __device__ __forceinline__ int out_floats(int joints) {
  return kChunk * (padded(joints * 9) + padded(joints * 3));
}

__host__ __device__ __forceinline__ int smem_bytes_for(int joints) {
  return 4 * (kStages * stage_floats(joints) + kOutSlots * out_floats(joints));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// the stage's one arrival, with the bytes its bulk copies will bring
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned tx_bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(tx_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(float* dst, const float* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// Calls fn(f, e, q) for the thread's share of `count` rows of `len` units,
// back to back: unit f = e * len + q, taken by thread f % kThreads; row and
// offset advance without a division in the loop.
template <typename Fn>
__device__ __forceinline__ void for_units(int len, int count, Fn fn) {
  const int de = kThreads / len, dq = kThreads - de * len;
  int e = threadIdx.x / len, q = threadIdx.x - e * len;
  for (int f = threadIdx.x; f < len * count; f += kThreads) {
    fn(f, e, q);
    e += de;
    q += dq;
    if (q >= len) {
      q -= len;
      ++e;
    }
  }
}

// `count` rows of `len` floats at `src` into shared-memory rows of `stride`,
// 4-byte `cp.async` copies of consecutive words by all threads
__device__ __forceinline__ void copy_in(float* dst, const float* src, int len, int stride,
                                        int count) {
  for_units(len, count, [&](int f, int e, int q) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst + e * stride + q)),
                 "l"(src + f)
                 : "memory");
  });
}

// the reverse of copy_in, with coalesced 4-byte stores
__device__ __forceinline__ void copy_out(float* dst, const float* src, int len, int stride,
                                         int count) {
  for_units(len, count, [&](int f, int e, int q) { dst[f] = src[e * stride + q]; });
}

// One step of lane a's chain: row a of R_j and p_j[a] from those of the
// parent (m0..m2, pp) and joint j's staged rot rj and off oj.
__device__ __forceinline__ void step(const float* rj, const float* oj, float m0, float m1,
                                     float m2, float pp, float& r0, float& r1, float& r2,
                                     float& p) {
  p = pp + (m0 * oj[0] + m1 * oj[1] + m2 * oj[2]);
  r0 = m0 * rj[0] + m1 * rj[3] + m2 * rj[6];
  r1 = m0 * rj[1] + m1 * rj[4] + m2 * rj[7];
  r2 = m0 * rj[2] + m1 * rj[5] + m2 * rj[8];
}

// Lane a of one env: row a of R_j and p_j[a] for every joint, from the
// staged rows r_in / o_in into r_out / p_out (row a's slots), starting from
// row a of rot_0 and p_0[a] = p.
//   kMujoco: the tree is known here, the 24 steps are straight-line code,
//   every row a later joint needs is a register (no branch, no load of a
//   parent), and the inputs come in 16-byte loads, a block of 4 joints
//   ahead.
//   Otherwise: a loop over `joints` and the parents in the argument block;
//   a parent that is the previous joint is still in registers.
template <bool kMujoco>
__device__ __forceinline__ void chain(const float* __restrict__ r_in,
                                      const float* __restrict__ o_in, float* __restrict__ r_out,
                                      float* __restrict__ p_out, int a, float p, int joints,
                                      const Parents& parents) {
  r_out += 3 * a;
  p_out += a;
  if constexpr (kMujoco) {
    constexpr int kBlocks = kHumanoidJoints / 4;
    float R[kHumanoidJoints][3], P[kHumanoidJoints];   // row a and p[a] of every joint
    float rb[2][36], ob[2][12];                        // blocks of 4 joints: rot, off
    auto load = [&](int b, float* rd, float* od) {
#pragma unroll
      for (int i = 0; i < 9; ++i)
        reinterpret_cast<float4*>(rd)[i] = reinterpret_cast<const float4*>(r_in + 36 * b)[i];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        reinterpret_cast<float4*>(od)[i] = reinterpret_cast<const float4*>(o_in + 12 * b)[i];
    };
    R[0][0] = r_in[3 * a], R[0][1] = r_in[3 * a + 1], R[0][2] = r_in[3 * a + 2];
    P[0] = p;
    load(0, rb[0], ob[0]);
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      if (b + 1 < kBlocks) load(b + 1, rb[(b + 1) & 1], ob[(b + 1) & 1]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * b + jj;
        if (j == 0) continue;
        const int q = mujoco_parent(j);
        step(rb[b & 1] + 9 * jj, ob[b & 1] + 3 * jj, R[q][0], R[q][1], R[q][2], P[q], R[j][0],
             R[j][1], R[j][2], P[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHumanoidJoints; ++j) {
      r_out[j * 9] = R[j][0];
      r_out[j * 9 + 1] = R[j][1];
      r_out[j * 9 + 2] = R[j][2];
      p_out[j * 3] = P[j];
    }
  } else {
    float r0 = r_in[3 * a], r1 = r_in[3 * a + 1], r2 = r_in[3 * a + 2];
    r_out[0] = r0;
    r_out[1] = r1;
    r_out[2] = r2;
    p_out[0] = p;
    for (int j = 1; j < joints; ++j) {
      float m0 = r0, m1 = r1, m2 = r2, pp = p;
      const int q = parents.p[j];
      if (q != j - 1) {   // the same for every lane: no divergence
        m0 = r_out[q * 9];
        m1 = r_out[q * 9 + 1];
        m2 = r_out[q * 9 + 2];
        pp = p_out[q * 3];
      }
      step(r_in + 9 * j, o_in + 3 * j, m0, m1, m2, pp, r0, r1, r2, p);
      r_out[j * 9] = r0;
      r_out[j * 9 + 1] = r1;
      r_out[j * 9 + 2] = r2;
      p_out[j * 3] = p;
    }
  }
}

// kMujoco: built for the MuJoCo-order humanoid tree (row lengths, strides
// and the chain are constants); otherwise any tree, read at run time.
template <bool kMujoco>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
fk_chain_kernel(const float* __restrict__ rot, const float* __restrict__ off,
                const float* __restrict__ root, float* __restrict__ pos, float* __restrict__ rm,
                int n, int joints_arg, int envs_per_cta, const __grid_constant__ Parents parents) {
  const int joints = kMujoco ? kHumanoidJoints : joints_arg;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int rlen = joints * 9, olen = joints * 3;
  const int rs = padded(rlen), os = padded(olen), sf = stage_floats(joints);
  float* out_slabs = smem + kStages * sf;
  const int64_t first = (int64_t)blockIdx.x * envs_per_cta;   // < n
  const int count = min(envs_per_cta, n - (int)first);
  const int chunks = (count + kChunk - 1) / kChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // bulk copies move rows of a multiple of 16 bytes between 16-byte aligned
  // ends (rows of 9J and 3J floats: J a multiple of 4)
  const bool bulk_in = (joints & 3) == 0 && aligned16(rot) && aligned16(off);
  const bool bulk_out = (joints & 3) == 0 && aligned16(rm) && aligned16(pos);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // chunk c into stage c % kStages: its bulk copies complete on the stage's
  // barrier, its 4-byte copies form one group per thread (an empty one past
  // the run, so that every thread counts the same groups)
  auto fetch = [&](int c) {
    if (c < chunks) {
      const int c0 = c * kChunk, cn = min(kChunk, count - c0);
      float* st = smem + (c % kStages) * sf;
      uint64_t* bar = &full[c % kStages];
      if (bulk_in) {
        if (warp == kCopyWarp) {
          if (lane == 0) mbar_arrive(bar, cn * (rlen + olen) * 4);
          __syncwarp();   // the bytes are expected before any copy lands
          if (lane < cn)
            bulk_load(st + lane * rs, rot + (first + c0 + lane) * rlen, rlen * 4, bar);
          else if (lane >= 16 && lane < 16 + cn)
            bulk_load(st + kChunk * rs + (lane - 16) * os, off + (first + c0 + lane - 16) * olen,
                      olen * 4, bar);
        }
      } else {
        copy_in(st, rot + (first + c0) * rlen, rlen, rs, cn);
        copy_in(st + kChunk * rs, off + (first + c0) * olen, olen, os, cn);
        if (threadIdx.x == 0) mbar_arrive(bar, 0);
      }
      copy_in(st + kChunk * (rs + os), root + (first + c0) * 3, 3, 3, cn);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int c = 0; c < kStages - 1; ++c) fetch(c);

  const int e = threadIdx.x / 3, a = threadIdx.x - 3 * e;   // env of the chunk, row
  for (int c = 0; c < chunks; ++c) {
    // stage (c + 2) % 3 held chunk c - 1, computed before the last barrier
    fetch(c + kStages - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    mbar_wait(&full[c % kStages], (c / kStages) & 1);
    // output slab c % 2 was last stored from by chunk c - 2
    if (bulk_out && warp == kCopyWarp)
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncthreads();   // chunk c staged; slab c % 2 free
    const int c0 = c * kChunk, cn = min(kChunk, count - c0);
    const float* st = smem + (c % kStages) * sf;
    float* s_rm = out_slabs + (c & 1) * out_floats(joints);
    float* s_pos = s_rm + kChunk * rs;
    if (e < cn) {
      chain<kMujoco>(st + e * rs, st + kChunk * rs + e * os, s_rm + e * rs, s_pos + e * os, a,
                     st[kChunk * (rs + os) + 3 * e + a], joints, parents);
      // the bulk stores read the slab through the async proxy
      if (bulk_out) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();   // chunk c computed
    if (bulk_out) {
      if (warp == kCopyWarp) {
        if (lane < cn)
          bulk_store(rm + (first + c0 + lane) * rlen, s_rm + lane * rs, rlen * 4);
        else if (lane >= 16 && lane < 16 + cn)
          bulk_store(pos + (first + c0 + lane - 16) * olen, s_pos + (lane - 16) * os, olen * 4);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      copy_out(rm + (first + c0) * rlen, s_rm, rlen, rs, cn);
      copy_out(pos + (first + c0) * olen, s_pos, olen, os, cn);
    }
  }
  // the slabs stay until the last bulk stores have read them
  if (bulk_out && warp == kCopyWarp) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// whether `parents` is the MuJoCo-order humanoid tree
bool is_mujoco(const int* parents, int joints) {
  if (joints != kHumanoidJoints) return false;
  for (int j = 1; j < joints; ++j)
    if (parents[j] != mujoco_parent(j)) return false;
  return true;
}

}  // namespace

extern "C" {

// pos (n, joints, 3) and rm (n, joints, 3, 3) from rot (n, joints, 3, 3),
// off (n, joints, 3) and root (n, 3), all f32 and contiguous (any 4-byte
// aligned base). `parents` is a host array of `joints` ints with
// parents[j] < j for j >= 1. `envs_per_cta` and `smem_bytes` are the launch
// shape of ops/fk.py `launch_shape`; the grid is ceil(n / envs_per_cta) CTAs
// of 96 threads, each walking its envs in chunks of 8. Returns the
// cudaError_t of the launch (0 = cudaSuccess), or cudaErrorInvalidValue for a
// tree or a launch shape the kernel does not take.
int fk_chain_f32(const float* rot, const float* off, const float* root, float* pos, float* rm,
                 int n, int joints, const int* parents, int envs_per_cta, int smem_bytes,
                 void* stream) {
  if (joints < 1 || joints > kMaxJoints) return (int)cudaErrorInvalidValue;
  if (envs_per_cta < 1) return (int)cudaErrorInvalidValue;
  if (smem_bytes != smem_bytes_for(joints)) return (int)cudaErrorInvalidValue;
  Parents par = {};
  for (int j = 1; j < joints; ++j) {
    if (parents[j] < 0 || parents[j] >= j) return (int)cudaErrorInvalidValue;
    par.p[j] = parents[j];
  }
  if (n <= 0) return 0;
  // above 48 KB a CTA's shared memory must be allowed once per device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(fk_chain_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes_for(kMaxJoints));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fk_chain_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes_for(kHumanoidJoints));
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  const unsigned blocks = (unsigned)((n + envs_per_cta - 1) / envs_per_cta);
  const cudaStream_t s = (cudaStream_t)stream;
  auto* kernel = is_mujoco(parents, joints) ? fk_chain_kernel<true> : fk_chain_kernel<false>;
  kernel<<<blocks, kThreads, smem_bytes, s>>>(rot, off, root, pos, rm, n, joints, envs_per_cta,
                                              par);
  return (int)cudaGetLastError();
}

// 1 where `fk_chain_f32` launches its straight-line build for this tree (the
// MuJoCo-order humanoid), 0 where it launches the loop
int fk_chain_tree(const int* parents, int joints) { return is_mujoco(parents, joints); }

}  // extern "C"
