/* Traceback walk over the Gotoh decision matrices, on the card.
 *
 * Replaces the device walk of kalign_tpu/tpu/traceback.py (_walk,
 * traceback_batch, traceback_lanewise), which is XLA there: walking on
 * the card means a level's decision matrices (hundreds of MB at a
 * 1024-problem leaf level) never leave device memory; only the
 * O(L1 + L2) step lists do.
 *
 * The walk starts at (la, lb) in the forward pass's end state and emits
 * 0 (match), 1 (gap in the rows, consumes a column) or 2 (gap in the
 * columns, consumes a row), with _walk's degenerate guards and its
 * DP-column-0 rule (column 0 is not stored; its only consulted bit is
 * GB's, "open" exactly at row 1), and stops after max_steps steps.  Once
 * the walk reaches row 0 or column 0 the guards leave one choice: the
 * rest of the walk is a straight run of 1s (row 0) or 2s (column 0), and
 * no decision is read.  Two decision layouts:
 *   rows:     int8 [B, L1p, L2p]               (row Gotoh kernel)
 *   lanewise: int32 [B, L2p/8, L1p], 8 cells   (problem-per-lane kernel;
 *             L1p a multiple of 4)
 *
 * Bound: latency.  A walk is a chain of dependent reads, one decision per
 * step; the bytes it must move (la + lb decisions read, max_steps written
 * per problem) are tiny.  Reading each decision from device memory costs
 * a round trip per step, so here one warp owns a problem and stages a
 * window of its decision matrix that ends at the walk's current cell in
 * shared memory, all 32 lanes loading at once (16-byte loads: 16 columns
 * of a row, or one nibble word of 4 rows, re-encoded on the way so that
 * the next state is one shift and mask).  Lane 0 then walks inside
 * the window at shared-memory latency, issuing each read before it
 * decodes the previous one (the next cell's address depends only on the
 * current state), until the walk leaves the window through its top or
 * left edge; then the warp stages the next window.  A walk spends at
 * least a window's side in steps inside each window.  The steps collect
 * in a per-warp shared-memory buffer and go out reversed into forward
 * order, padded with 3, by the whole warp.  When max_steps exceeds the
 * buffer, full buffers are flushed to the output in walk order and the
 * warp reverses the row in place at the end.  Warps per block, window and
 * buffer sizes come from the wrapper (gpu/traceback.py::launch_plan).
 *
 * One band of a column-sharded DP (parallel/mesh.py): the rows layout
 * holds only the DP columns col0 + 1 .. col0 + L2p, and the walk starts
 * at any cell and state (la, lb and st).  It stops where its column
 * reaches col0 > 0, the band's left edge, and leaves there the cell and
 * the state it would go on from (end: i, j, s a problem), which the
 * band to the left starts at.  A straight run along row 0 stops there
 * too.  With col0 0 the walk is the whole walk above.
 */
#include "kt_cuda.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// four decision bytes re-encoded for the walker: bits 1-0 hold the next
// state from A (d & 3), bit 2 the next from GA (1 if it extends), bit 5
// the next from GB (2 if it extends), so the next state from state s is
// (e >> 2s) & 3
__device__ __forceinline__ uint32_t walk_code(uint32_t x) {
  return (x & 0x07070707u) | ((x & 0x08080808u) << 2);
}

template <bool kLanewise>
__global__ void walk_kernel(const void* __restrict__ dec,
                            const int32_t* __restrict__ la_arr,
                            const int32_t* __restrict__ lb_arr,
                            const int32_t* __restrict__ st_arr, int B,
                            int L1p, int L2p, int max_steps, int win_rows,
                            int win_cols, int buf_bytes,
                            int8_t* __restrict__ steps_out,
                            int32_t* __restrict__ n_out,
                            int32_t* __restrict__ win_out, int col0,
                            int32_t* __restrict__ end_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  // per warp: the step buffer, then the window (a read just above or left
  // of the window lands in the buffer, still shared memory)
  uint8_t* buf = smem + (size_t)warp * (buf_bytes + win_rows * win_cols);
  uint8_t* win = buf + buf_bytes;
  int8_t* out = steps_out + (size_t)b * max_steps;
  // window loads: lanes split a window row into 16-byte chunks (rows
  // layout) or 4-byte words (lanewise, 4 rows per load), chunks per row a
  // power of two
  const int per_row = kLanewise ? win_cols >> 3 : win_cols >> 4;
  const int lg = __ffs(per_row) - 1;

  int i = la_arr[b];
  int j = lb_arr[b];
  int s = st_arr[b];
  int n = 0;        // steps emitted
  int flushed = 0;  // steps already written out in walk order
  int windows = 0;  // windows staged
  while (n < max_steps && (i > 0 || j > 0) && (col0 == 0 || j > col0)) {
    if (n - flushed == buf_bytes) {
      for (int k = lane; k < buf_bytes; k += 32) out[flushed + k] = buf[k];
      flushed += buf_bytes;
      __syncwarp();
      continue;
    }
    if (i == 0 || j == 0) {
      // (j == 0 only where col0 is 0)
      const uint8_t v = i == 0 ? 1 : 2;
      const int cnt = min(min(i == 0 ? j - col0 : i, max_steps - n),
                          buf_bytes - (n - flushed));
      for (int k = lane; k < cnt; k += 32) buf[n - flushed + k] = v;
      n += cnt;
      if (i == 0)
        j -= cnt;
      else
        i -= cnt;
      __syncwarp();
      continue;
    }

    // stage the window whose bottom row is decision row r = i - 1 and
    // whose columns end at the chunk holding column c = j - 1 (of the
    // band's own, j - 1 - col0)
    const int r = i - 1;
    const int c = j - 1 - col0;
    int r0, c0;
    if (kLanewise) {
      // rows in groups of 4 (one 16-byte load per word), the window's
      // last group holding row r
      const int W8 = L2p >> 3;
      const int rend = ((r >> 2) + 1) << 2;
      r0 = max(0, rend - win_rows);
      const int ng = (rend - r0) >> 2;
      const int wend = (c >> 3) + 1;
      const int w0 = max(0, wend - per_row);
      const int nw = wend - w0;
      c0 = w0 << 3;
      const int32_t* src = static_cast<const int32_t*>(dec) +
                           ((size_t)b * W8 + w0) * L1p + r0;
      const int w = lane & (per_row - 1);
      if (w < nw) {
        for (int g = lane >> lg; g < ng; g += 32 >> lg) {
          const uint4 x = *reinterpret_cast<const uint4*>(
              src + (size_t)w * L1p + 4 * g);
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int k = 0; k < 4; k++) {
            const uint32_t lo = xs[k] & 0x0F0F0F0Fu;
            const uint32_t hi = (xs[k] >> 4) & 0x0F0F0F0Fu;
            uint2 v;
            v.x = walk_code(__byte_perm(lo, hi, 0x5140));
            v.y = walk_code(__byte_perm(lo, hi, 0x7362));
            *reinterpret_cast<uint2*>(win + (4 * g + k) * win_cols + 8 * w) =
                v;
          }
        }
      }
    } else {
      r0 = max(0, r - win_rows + 1);
      const int nr = r - r0 + 1;
      const int cend = (c & ~15) + 16;
      c0 = max(0, cend - win_cols);
      const int nq = (cend - c0) >> 4;
      const uint8_t* src = static_cast<const uint8_t*>(dec) +
                           ((size_t)b * L1p + r0) * L2p + c0;
      const int q = lane & (per_row - 1);
      if (q < nq) {
        for (int k = lane >> lg; k < nr; k += 32 >> lg) {
          uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)k * L2p +
                                                    16 * q);
          v.x = walk_code(v.x);
          v.y = walk_code(v.y);
          v.z = walk_code(v.z);
          v.w = walk_code(v.w);
          *reinterpret_cast<uint4*>(win + k * win_cols + 16 * q) = v;
        }
      }
    }
    windows++;
    __syncwarp();

    if (lane == 0) {
      int rr = r - r0;
      int cc = c - c0;
      const uint8_t* p = win + rr * win_cols + cc;
      uint8_t* o = buf + (n - flushed);
      uint8_t* const o_end = buf + min(buf_bytes, max_steps - flushed);
      uint32_t e = *p;
      for (;;) {
        *o++ = (uint8_t)s;
        const int dr = s != 1;
        const int dc = s != 2;
        rr -= dr;
        cc -= dc;
        p -= dr * win_cols + dc;
        const uint32_t e_next = *p;
        s = (int)((e >> (2 * s)) & 3u);
        e = e_next;
        if ((rr | cc) < 0 || o == o_end) break;
      }
      n = flushed + (int)(o - buf);
      i = rr + r0 + 1;
      j = cc + c0 + 1 + col0;
    }
    i = __shfl_sync(kFull, i, 0);
    j = __shfl_sync(kFull, j, 0);
    s = __shfl_sync(kFull, s, 0);
    n = __shfl_sync(kFull, n, 0);
    // lane 0's buffer writes before the next flush or window reads them
    __syncwarp();
  }

  __syncwarp();
  if (flushed == 0) {
    for (int k = lane; k < max_steps; k += 32)
      out[k] = k < n ? (int8_t)buf[n - 1 - k] : (int8_t)3;
  } else {
    for (int k = lane; k < n - flushed; k += 32) out[flushed + k] = buf[k];
    __syncwarp();
    for (int a = lane; a < n / 2; a += 32) {
      const int8_t tmp = out[a];
      out[a] = out[n - 1 - a];
      out[n - 1 - a] = tmp;
    }
    for (int k = n + lane; k < max_steps; k += 32) out[k] = 3;
  }
  if (lane == 0) {
    n_out[b] = n;
    if (win_out) win_out[b] = windows;
    if (end_out) {
      end_out[3 * b] = i;
      end_out[3 * b + 1] = j;
      end_out[3 * b + 2] = s;
    }
  }
}

template <bool kLanewise>
int launch(const void* dec, const int32_t* la, const int32_t* lb,
           const int32_t* st, int B, int L1p, int L2p, int max_steps,
           int warps, int win_rows, int win_cols, int buf_bytes,
           int8_t* steps, int32_t* n, int32_t* windows, int col0,
           int32_t* end, cudaStream_t stream) {
  const size_t smem = (size_t)warps * (buf_bytes + win_rows * win_cols);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        walk_kernel<kLanewise>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + warps - 1) / warps;
  walk_kernel<kLanewise><<<blocks, warps * 32, smem, stream>>>(
      dec, la, lb, st, B, L1p, L2p, max_steps, win_rows, win_cols,
      buf_bytes, steps, n, windows, col0, end);
  return (int)cudaGetLastError();
}

}  // namespace

/* win_cols: a power of two, 16..512 (rows layout) or 8..256 (lanewise);
 * buf_bytes a multiple of 16 above win_cols; rows layout: L2p a multiple
 * of 16; lanewise: L1p (the decision rows) and win_rows multiples of 4.
 * windows: null, or [B] int32 that receives the windows each walk
 * staged.  col0: the DP column before the decisions' first (a band's; 0
 * for a whole matrix, and always on the lanewise layout); end: null, or
 * [B, 3] int32 that receives each walk's last cell and state. */
KT_EXPORT int kt_traceback(int lanewise, const void* dec, const int32_t* la,
                           const int32_t* lb, const int32_t* st, int B,
                           int L1p, int L2p, int max_steps, int warps,
                           int win_rows, int win_cols, int buf_bytes,
                           int8_t* steps, int32_t* n, int32_t* windows,
                           int col0, int32_t* end, void* stream) {
  const int chunk = lanewise ? 8 : 16;
  const int per_row = win_cols / chunk;
  if (warps < 1 || warps > 32 || win_rows < 1 || per_row < 1 ||
      per_row > 32 || (per_row & (per_row - 1)) || win_cols % chunk ||
      buf_bytes % 16 || buf_bytes <= win_cols || (!lanewise && L2p % 16) ||
      L2p % 8 || (lanewise && (L1p % 4 || win_rows % 4)) || col0 < 0 ||
      (lanewise && col0))
    return (int)cudaErrorInvalidValue;
  if (lanewise)
    return launch<true>(dec, la, lb, st, B, L1p, L2p, max_steps, warps,
                        win_rows, win_cols, buf_bytes, steps, n, windows, 0,
                        end, (cudaStream_t)stream);
  return launch<false>(dec, la, lb, st, B, L1p, L2p, max_steps, warps,
                       win_rows, win_cols, buf_bytes, steps, n, windows,
                       col0, end, (cudaStream_t)stream);
}
