/* Batched Myers bit-parallel edit distance (anchor distances).
 *
 * Replaces kalign_tpu/tpu/bpm_pallas.py::_kernel (bpm_batch_pallas).
 * Same function as the reference's blocked 64-bit kernel
 * (lib/src/bpm.c:356-580, native kt_bpm_block): patterns of up to 1024
 * symbols in 64-bit blocks, text padded with W = 64*b_max - m symbols
 * of code 0, the adaptive active-block window (grow into block y+1 when
 * the band may improve, retract while the bottom block is hopeless),
 * and the minimum score over the bottom row.
 *
 * Design: one thread per (text, pattern) pair; the card has native
 * 64-bit integer lanes, so a block is one uint64_t (the TPU kernel
 * splits it into u32 lo/hi pairs with an explicit carry).  The window
 * is followed exactly, so only the live blocks are computed (the TPU
 * kernel computes every block and masks).  The pattern's match masks
 * (Peq [P, 13, nblk], built by the wrapper) and the text rows of the
 * device-resident token table are read from global memory; the
 * per-pair block state (vp, vn, score: at most 16 blocks) stays in the
 * thread's local memory.
 *
 * Bound: integer operations.  Each text symbol costs ~17 64-bit logic /
 * add / shift operations per live block; the bytes (one text byte per
 * step, the Peq rows) are far below that at the card's rates.
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 128;
constexpr int kSigma = 13;
constexpr int kMaxBlocks = 16;
constexpr int kWord = 64;

__device__ __forceinline__ int block_step(uint64_t q, uint64_t& vp,
                                          uint64_t& vn, int h_in) {
  const uint64_t pv = vp;
  const uint64_t mv = vn;
  const uint64_t xv = q | mv;
  if (h_in < 0) q |= 1ULL;
  const uint64_t xh = (((q & pv) + pv) ^ pv) | q;
  uint64_t ph = mv | ~(xh | pv);
  uint64_t mh = pv & xh;
  int h_out = 0;
  if (ph >> 63) h_out += 1;
  if (mh >> 63) h_out -= 1;
  ph <<= 1;
  mh <<= 1;
  if (h_in < 0) mh |= 1ULL;
  else if (h_in > 0) ph |= 1ULL;
  vp = mh | ~(xv | ph);
  vn = ph & xv;
  return h_out;
}

__global__ void __launch_bounds__(kThreads)
bpm_kernel(const uint8_t* __restrict__ tok, int64_t tok_stride,
           const int32_t* __restrict__ text_idx,
           const int32_t* __restrict__ n_arr,
           const uint64_t* __restrict__ peq,   // [P, 13, nblk]
           const int32_t* __restrict__ m_arr, int P, int nblk,
           int32_t* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int n = n_arr[p];
  int m = m_arr[p];
  if (m > nblk * kWord) m = nblk * kWord;
  const int b_max = (m == 0) ? 1 : (m + kWord - 1) / kWord;
  const int W = kWord * b_max - m;
  const int maxd = m;
  int best = m;
  const uint8_t* text = tok + (size_t)text_idx[p] * tok_stride;
  const uint64_t* eq = peq + (size_t)p * kSigma * nblk;

  uint64_t vp[kMaxBlocks], vn[kMaxBlocks];
  int score[kMaxBlocks];
  int y = b_max - 1;
  for (int b = 0; b <= y; b++) {
    vp[b] = ~0ULL;
    vn[b] = 0;
    score[b] = (b + 1) * kWord;
  }

  for (int i = 0; i < n + W; i++) {
    const int c = (i >= n) ? 0 : text[i];
    const uint64_t* eqc = eq + (size_t)c * nblk;
    int carry = 0;
    for (int b = 0; b <= y; b++) {
      carry = block_step(eqc[b], vp[b], vn[b], carry);
      score[b] += carry;
    }
    if ((score[y] - carry <= maxd) && (y < b_max - 1) &&
        ((eqc[y + 1] & 1ULL) || carry < 0)) {
      y += 1;
      vp[y] = ~0ULL;
      vn[y] = 0;
      const int h_out = block_step(eqc[y], vp[y], vn[y], carry);
      score[y] = score[y - 1] + kWord - carry + h_out;
    } else {
      while (score[y] >= maxd + kWord) {
        if (y == 0) break;
        y -= 1;
      }
    }
    if (score[y] < best) best = score[y];
  }
  out[p] = best;
}

}  // namespace

KT_EXPORT int kt_bpm_batch(const uint8_t* tok, int64_t tok_stride,
                           const int32_t* text_idx, const int32_t* n,
                           const uint64_t* peq, const int32_t* m, int P,
                           int nblk, int32_t* out, void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const int blocks = (P + kThreads - 1) / kThreads;
  bpm_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tok, tok_stride, text_idx, n, peq, m, P, nblk, out);
  return (int)cudaGetLastError();
}
