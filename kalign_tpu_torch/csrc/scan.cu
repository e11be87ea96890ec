/* Prefix sums of the Gotoh kernels' scan transform, left to right in
 * float32.
 *
 * Replaces the XLA cumsums that feed the TPU Gotoh kernels
 * (kalign_tpu/tpu/gotoh_pallas.py:309-338, gotoh_lanewise.py:334-341):
 * C_norm / C_term (prefix sums of a merge's column gap extensions) and
 * the column-0 terminal-gap run of its rows.  Their summation order
 * decides near-ties, so it is part of the float contract: this kernel
 * adds strictly left to right in float32, the order of numpy's cumsum
 * (what the plain version and kalign_tpu's oracles use), which
 * torch.cumsum follows on neither device.
 *
 * Design: one thread per row, a sequential loop over the row.  The rows
 * are a few hundred to a few thousand floats and a bucket has at most a
 * few thousand rows, so the launch is latency-bound whatever its layout;
 * what matters is that the vectors stay on the card (no round trip to
 * the host per bucket).
 *
 * Bound: device-memory bytes — each input float read once, each output
 * float written once.
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
prefix_sum_kernel(const float* __restrict__ x, long long row_stride, int R,
                  int W, float* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const float* xr = x + (size_t)r * row_stride;
  float* orow = out + (size_t)r * W;
  float s = 0.0f;
  for (int j = 0; j < W; j++) {
    s = s + xr[j];
    orow[j] = s;
  }
}

}  // namespace

KT_EXPORT int kt_prefix_sum_f32(const float* x, long long row_stride, int R,
                                int W, float* out, void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  prefix_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, row_stride, R, W, out);
  return (int)cudaGetLastError();
}
