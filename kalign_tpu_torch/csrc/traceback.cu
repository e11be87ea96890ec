/* Traceback walk over the Gotoh decision matrices, on the card.
 *
 * Replaces the device walk of kalign_tpu/tpu/traceback.py (_walk,
 * traceback_batch, traceback_lanewise), which is XLA there: walking on
 * the card means a level's decision matrices (hundreds of MB at a
 * 1024-problem leaf level) never leave device memory; only the
 * O(L1 + L2) step lists do.
 *
 * Design: one thread per problem.  The walk starts at (la, lb) in the
 * forward pass's end state and emits 0 (match), 1 (gap in the rows,
 * consumes a column) or 2 (gap in the columns, consumes a row), with
 * _walk's degenerate guards and its DP-column-0 rule (column 0 is not
 * stored; its only consulted bit is GB's, "open" exactly at row 1).
 * The steps are written in reverse, then reversed in place and padded
 * with 3.  Two decision layouts:
 *   rows:     int8 [B, L1p, L2p]              (row Gotoh kernel)
 *   lanewise: int32 [L1p, L2p/8, B], 8 cells  (problem-per-lane kernel)
 *
 * Bound: latency.  A walk is a chain of dependent one-byte gathers;
 * the bytes it must move (la + lb decisions read, max_steps written per
 * problem) are tiny next to the forward pass.
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 128;

template <bool kLanewise>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const void* __restrict__ dec, const int32_t* __restrict__ la_arr,
            const int32_t* __restrict__ lb_arr,
            const int32_t* __restrict__ st_arr, int B, int L1p, int L2p,
            int max_steps, int8_t* __restrict__ steps_out,
            int32_t* __restrict__ n_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int i = la_arr[b];
  int j = lb_arr[b];
  int s = st_arr[b];
  int8_t* out = steps_out + (size_t)b * max_steps;
  int n = 0;
  while ((i > 0 || j > 0) && n < max_steps) {
    const int r = i > 1 ? i - 1 : 0;
    const int c = j > 1 ? j - 1 : 0;
    int d;
    if (j == 0) {
      d = (i > 1) ? KT_DEC_GB_EXT : 0;
    } else if (kLanewise) {
      const int32_t* d32 = static_cast<const int32_t*>(dec);
      const uint32_t w =
          (uint32_t)d32[((size_t)r * (L2p / 8) + (c >> 3)) * B + b];
      d = (int)((w >> (4 * (c & 7))) & 0xFu);
    } else {
      const int8_t* d8 = static_cast<const int8_t*>(dec);
      d = (int)(uint8_t)d8[((size_t)b * L1p + r) * L2p + c];
    }
    if (s == 0 && (i == 0 || j == 0)) s = (j > 0) ? 1 : 2;
    if (s == 1 && j == 0) s = 2;
    if (s == 2 && i == 0) s = 1;
    out[n++] = (int8_t)s;
    if (s == 0) {
      i--;
      j--;
      s = d & KT_DEC_A_MASK;
    } else if (s == 1) {
      j--;
      s = (d & KT_DEC_GA_EXT) ? 1 : 0;
    } else {
      i--;
      s = (d & KT_DEC_GB_EXT) ? 2 : 0;
    }
  }
  for (int a = 0, z = n - 1; a < z; a++, z--) {
    const int8_t tmp = out[a];
    out[a] = out[z];
    out[z] = tmp;
  }
  for (int k = n; k < max_steps; k++) out[k] = 3;
  n_out[b] = n;
}

}  // namespace

KT_EXPORT int kt_traceback(int lanewise, const void* dec, const int32_t* la,
                           const int32_t* lb, const int32_t* st, int B,
                           int L1p, int L2p, int max_steps, int8_t* steps,
                           int32_t* n, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  if (lanewise) {
    walk_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        dec, la, lb, st, B, L1p, L2p, max_steps, steps, n);
  } else {
    walk_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        dec, la, lb, st, B, L1p, L2p, max_steps, steps, n);
  }
  return (int)cudaGetLastError();
}
