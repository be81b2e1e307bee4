// The tracer's device stamp (vid2player3d_torch/utils/trace.py): one thread
// reads the device's global nanosecond timer (%globaltimer) and writes it
// into a static int64 buffer, on the launching stream, so the stamp lands
// where the stream reaches it. Captured into a CUDA graph it runs at every
// replay, which is what a host-side span cannot do.
//
// A graph's buffer is a ring of `capacity` rows of `width` slots, one row per
// replay; `row` is a device counter the graph itself advances, so every
// replay of an epoch keeps its own row and nothing is read on the host until
// the epoch is over. The first stamp of a replay takes the next row and
// advances the counter; the others write into the row it took. An eager
// stamp writes slot `slot` of a flat buffer and reads no counter.
//
// The work is one 8-byte store; a stamp costs its launch (a graph kernel
// node, about a microsecond).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// mode 0: buf[slot]; mode 1: the replay's first stamp (takes row *row and
// advances it); mode 2: a later stamp of the same replay (row *row - 1)
__global__ void stamp_kernel(long long* buf, long long* row, int capacity, int width, int slot,
                             int mode) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long r = 0;
  if (mode == 1) {
    r = row[0];
    row[0] = r + 1;
  } else if (mode == 2) {
    r = row[0] - 1;
  }
  const long long at = mode == 0 ? slot : (r % capacity) * width + slot;
  buf[at] = (long long)now;
}

}  // namespace

extern "C" {

// One stamp on `stream`. `buf` holds `capacity` x `width` int64 (mode 1, 2)
// or at least `slot` + 1 (mode 0); `row` one int64 (mode 1, 2; may be null in
// mode 0). Returns the cudaError_t of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int trace_stamp(void* buf, void* row, int capacity, int width, int slot, int mode,
                void* stream) {
  if (buf == nullptr || mode < 0 || mode > 2 || slot < 0) return (int)cudaErrorInvalidValue;
  if (mode != 0 && (row == nullptr || capacity < 1 || width < 1 || slot >= width))
    return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)buf, (long long*)row, capacity,
                                                   width, slot, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
