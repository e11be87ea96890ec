/* Bit-parallel pairwise edit distance for the guide-tree builder.
 *
 * Exact re-implementation of the reference semantics:
 *   - kt_bpm_block  ~ bpm_block      (lib/src/bpm.c:356-580)
 * with the 13-symbol reduced alphabet assumption (codes 0..12).  The
 * GPU kernel kalign_tpu_torch/csrc/bpm.cu computes the same function.
 */
#include "kt_api.h"

#include <cstring>

namespace {

constexpr int kSigma = 13;
constexpr int kMaxPattern = 1024;
constexpr int kWordBits = 64;
constexpr int kMaxBlocks = kMaxPattern / kWordBits;

inline int div_ceil_ref(int a, int b) {
  /* reference DIV_CEIL treats 0 as 1 (bpm.c:12) */
  return a == 0 ? 1 : a / b + (a % b == 0 ? 0 : 1);
}

}  // namespace

extern "C" int32_t kt_bpm_block(const uint8_t* text, const uint8_t* pattern,
                                int32_t n, int32_t m) {
  if (m > kMaxPattern) m = kMaxPattern;

  const int b_max = div_ceil_ref(m, kWordBits);
  const uint64_t kHigh = 1ULL << (kWordBits - 1);
  const int W = kWordBits * b_max - m;  /* padding columns appended to text */
  int32_t best = m;
  const int32_t maxd = m;

  uint64_t eq[kSigma][kMaxBlocks];
  std::memset(eq, 0, sizeof(eq));
  for (int c = 0; c < kSigma; c++) {
    for (int blk = 0; blk < b_max; blk++) {
      uint64_t bit = 1;
      for (int i = blk * kWordBits; i < (blk + 1) * kWordBits; i++) {
        /* positions past the pattern end match every symbol */
        if (i >= m || pattern[i] == c) eq[c][blk] |= bit;
        bit <<= 1;
      }
    }
  }

  uint64_t vp[kMaxBlocks], vn[kMaxBlocks];
  int32_t score[kMaxBlocks];
  int y = div_ceil_ref(maxd, kWordBits) - 1;
  for (int b = 0; b <= y; b++) {
    vp[b] = ~0ULL;
    vn[b] = 0;
    score[b] = (b + 1) * kWordBits;
  }

  for (int i = 0; i < n + W; i++) {
    const uint8_t c = (i >= n) ? 0 : text[i];
    int carry = 0;

    for (int b = 0; b <= y; b++) {
      uint64_t pv = vp[b];
      uint64_t mv = vn[b];
      uint64_t q = eq[c][b];
      const int h_in = carry;
      int h_out = 0;

      const uint64_t xv = q | mv;
      if (h_in < 0) q |= 1ULL;
      const uint64_t xh = (((q & pv) + pv) ^ pv) | q;

      uint64_t ph = mv | ~(xh | pv);
      uint64_t mh = pv & xh;

      if (ph & kHigh) h_out += 1;
      if (mh & kHigh) h_out -= 1;
      ph <<= 1;
      mh <<= 1;
      if (h_in < 0) mh |= 1ULL;
      else if (h_in > 0) ph |= 1ULL;

      vp[b] = mh | ~(xv | ph);
      vn[b] = ph & xv;

      carry = h_out;
      score[b] += carry;
    }

    /* adaptive window: grow into the next block when the band may improve,
       otherwise retract while the bottom of the window is hopeless
       (bpm.c:510-567) */
    if ((score[y] - carry <= maxd) && (y < b_max - 1) &&
        ((eq[c][y + 1] & 1ULL) || carry < 0)) {
      y += 1;
      const int b = y;
      uint64_t pv = ~0ULL;
      uint64_t mv = 0;
      uint64_t q = eq[c][b];
      const int h_in = carry;
      int h_out = 0;

      const uint64_t xv = q | mv;
      if (h_in < 0) q |= 1ULL;
      const uint64_t xh = (((q & pv) + pv) ^ pv) | q;

      uint64_t ph = mv | ~(xh | pv);
      uint64_t mh = pv & xh;
      if (ph & kHigh) h_out += 1;
      if (mh & kHigh) h_out -= 1;
      ph <<= 1;
      mh <<= 1;
      if (h_in < 0) mh |= 1ULL;
      else if (h_in > 0) ph |= 1ULL;

      vp[b] = mh | ~(xv | ph);
      vn[b] = ph & xv;

      score[y] = score[y - 1] + kWordBits - carry + h_out;
    } else {
      while (score[y] >= maxd + kWordBits) {
        if (y == 0) break;
        y -= 1;
      }
    }
    if (score[y] < best) best = score[y];
  }
  return best;
}
