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
 * torch.cumsum follows on neither device.  No association is changed:
 * each row is one serial chain of float adds.
 *
 * One launch takes up to kMaxSets row sets (e.g. the three vectors of
 * gotoh_row.prepare), each an [R, W] view with contiguous rows and any
 * row stride, written to a contiguous [R, W] output.
 *
 * Design: a block owns a tile of `rows` rows (1..kMaxRows, chosen so a
 * launch of ~1,000 rows spreads over all 132 SMs) and walks it in
 * column tiles of kTileW floats:
 *   1. the block's 128 threads stage the tile into shared memory, whole
 *      warps on consecutive floats of a row (coalesced);
 *   2. thread i < rows runs row i's serial chain from shared memory,
 *      carrying the running sum across column tiles; rows are padded to
 *      kTileW + 1 floats, so the `rows` threads hit distinct banks;
 *   3. the block writes the tile back, again coalesced.
 *
 * Bound: device-memory bytes — each input float read once, each output
 * float written once.  What is left once the accesses are coalesced is
 * the latency of one row's W dependent adds (~4 cycles each).
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;
constexpr int kTileW = 512;
constexpr int kPitch = kTileW + 1;
constexpr int kMaxSets = 4;
constexpr int kTargetBlocks = 264;  // two blocks per SM

struct ScanSet {
  const float* x;
  long long stride;
  float* out;
  int R, W;
  int block0;  // first block of this set
};

struct ScanSets {
  ScanSet s[kMaxSets];
  int n;
  int rows;  // rows per block
};

__global__ void __launch_bounds__(kThreads)
prefix_sum_kernel(__grid_constant__ const ScanSets sets) {
  __shared__ float tile[kMaxRows * kPitch];
  int k = 0;
  while (k + 1 < sets.n && (int)blockIdx.x >= sets.s[k + 1].block0) k++;
  const ScanSet& S = sets.s[k];
  const int r0 = ((int)blockIdx.x - S.block0) * sets.rows;
  const int nr = min(sets.rows, S.R - r0);
  const int t = threadIdx.x;
  float carry = 0.0f;
  for (int c0 = 0; c0 < S.W; c0 += kTileW) {
    const int tw = min(kTileW, S.W - c0);
    const int n = nr * tw;
    for (int e = t; e < n; e += kThreads) {
      const int i = e / tw, j = e - i * tw;
      tile[i * kPitch + j] = S.x[(size_t)(r0 + i) * S.stride + c0 + j];
    }
    __syncthreads();
    if (t < nr) {
      float* row = tile + t * kPitch;
      float s = carry;
#pragma unroll 8
      for (int j = 0; j < tw; j++) {
        s = __fadd_rn(s, row[j]);
        row[j] = s;
      }
      carry = s;
    }
    __syncthreads();
    for (int e = t; e < n; e += kThreads) {
      const int i = e / tw, j = e - i * tw;
      S.out[(size_t)(r0 + i) * S.W + c0 + j] = tile[i * kPitch + j];
    }
    __syncthreads();
  }
}

int rows_per_block(int total_rows) {
  const int rows = total_rows / kTargetBlocks;
  return rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
}

}  // namespace

/* n sets (n <= kMaxSets), five int64 each in desc: the address of an
 * [R, W] float32 view (R > 0, W > 0), its row stride, R, W, and the
 * address of a contiguous [R, W] output. */
KT_EXPORT int kt_prefix_sums_f32(int n, const long long* desc,
                                 void* stream) {
  if (n < 1 || n > kMaxSets) return (int)cudaErrorInvalidValue;
  ScanSets sets;
  int total_rows = 0;
  for (int k = 0; k < n; k++) total_rows += (int)desc[5 * k + 2];
  sets.n = n;
  sets.rows = rows_per_block(total_rows);
  int blocks = 0;
  for (int k = 0; k < n; k++) {
    const long long* d = desc + 5 * k;
    if (d[2] < 1 || d[3] < 1) return (int)cudaErrorInvalidValue;
    sets.s[k] = ScanSet{(const float*)d[0], d[1], (float*)d[4], (int)d[2],
                        (int)d[3], blocks};
    blocks += ((int)d[2] + sets.rows - 1) / sets.rows;
  }
  prefix_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(sets);
  return (int)cudaGetLastError();
}
