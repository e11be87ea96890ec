/* Latency probe for the traceback walk's chain floor (chip_smoke.py).
 *
 * One thread follows a chain of dependent loads, p = next[p], `hops`
 * times from `start`, through shared memory (the chain staged there by
 * the block first) or through device memory.  Each load's address is the
 * value of the one before, so the launch takes hops times the latency of
 * one load, plus a fixed cost that the caller cancels by timing two chain
 * lengths.  The shared chain is the walk's step (a dependent
 * shared-memory read); the device-memory chain, over an array far larger
 * than L2 in random order, is its window load (one round trip).
 *
 * Built by chip_smoke.py (nvcc for sm_90a, plain C interface).
 */
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void chase_shared(const uint32_t* __restrict__ next, int len,
                             int start, int hops, uint32_t* __restrict__ sink) {
  extern __shared__ uint32_t s[];
  for (int k = threadIdx.x; k < len; k += blockDim.x) s[k] = next[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t p = start;
  for (int h = 0; h < hops; h++) p = s[p];
  *sink = p;
}

__global__ void chase_device(const uint32_t* next, int start, int hops,
                             uint32_t* __restrict__ sink) {
  uint32_t p = start;
  for (int h = 0; h < hops; h++) p = next[p];
  *sink = p;
}

}  // namespace

/* shared != 0: next holds len entries (at most 48K) and the chain runs in
 * shared memory; else in device memory.  Returns cudaGetLastError(). */
extern "C" int kt_probe_chase(int shared, const uint32_t* next, int len,
                              int start, int hops, uint32_t* sink,
                              void* stream) {
  if (shared) {
    const size_t smem = (size_t)len * sizeof(uint32_t);
    if (len < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    chase_shared<<<1, 256, smem, (cudaStream_t)stream>>>(next, len, start,
                                                         hops, sink);
  } else {
    chase_device<<<1, 1, 0, (cudaStream_t)stream>>>(next, start, hops, sink);
  }
  return (int)cudaGetLastError();
}
