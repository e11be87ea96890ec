/* Bit-parallel pairwise edit distances + distance matrices.
 *
 * Exact re-implementation of the reference semantics:
 *   - kt_bpm_block  ~ bpm_block      (lib/src/bpm.c:356-580)
 *   - kt_edit_oracle ~ dyn_256       (lib/src/bpm.c:28-91)
 *   - kt_dist_to_anchors ~ d_estimation(pair=0)
 *                                    (lib/src/sequence_distance.c:82-131)
 * including the short-sequence preference bias and the 13-symbol reduced
 * alphabet assumption (codes 0..12).
 */
#include "kt_api.h"

#include <algorithm>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

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

extern "C" int32_t kt_edit_oracle(const uint8_t* text, const uint8_t* pattern,
                                  int32_t n, int32_t m) {
  if (m > 255) m = 255;
  std::vector<uint8_t> prev(257), cur(257);
  cur[0] = 0;
  for (int j = 1; j <= m; j++) cur[j] = cur[j - 1] + 1;
  std::swap(prev, cur);
  for (int i = 1; i <= n; i++) {
    cur[0] = prev[0];
    for (int j = 1; j < m; j++) {
      uint8_t c = (text[i - 1] == pattern[j - 1]) ? 0 : 1;
      uint8_t v = prev[j - 1] + c;
      v = std::min<uint8_t>(v, prev[j] + 1);
      v = std::min<uint8_t>(v, cur[j - 1] + 1);
      cur[j] = v;
    }
    {
      int j = m;
      uint8_t c = (text[i - 1] == pattern[j - 1]) ? 0 : 1;
      uint8_t v = prev[j - 1] + c;
      v = std::min<uint8_t>(v, prev[j]); /* free vertical move in last col */
      v = std::min<uint8_t>(v, cur[j - 1] + 1);
      cur[j] = v;
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

namespace kt {

/* longer sequence is the text, shorter the pattern
   (sequence_distance.c:153-162) */
float pair_distance(const uint8_t* sa, int la, const uint8_t* sb, int lb) {
  uint32_t d;
  if (la > lb) {
    d = (uint32_t)kt_bpm_block(sa, sb, la, lb);
  } else {
    d = (uint32_t)kt_bpm_block(sb, sa, lb, la);
  }
  return (float)d;
}

/* short-sequence preference bias (sequence_distance.c:71-74,121-123) */
float length_bias(int la, int lb) {
  int s = (la + lb) / 2;
  return (float)(std::min(10000.0, (double)s) / 10000.0);
}

}  // namespace kt

extern "C" void kt_dist_to_anchors(const uint8_t* flat, const int64_t* off,
                                   const int32_t* len, int32_t numseq,
                                   const int32_t* anchors, int32_t n_anchors,
                                   float* out, int32_t n_threads) {
  int stride = ((n_anchors + 7) / 8) * 8;
#ifdef _OPENMP
  omp_set_num_threads(n_threads > 0 ? n_threads : 1);
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int32_t i = 0; i < numseq; i++) {
    for (int32_t j = 0; j < n_anchors; j++) {
      const uint8_t* s1 = flat + off[i];
      const uint8_t* s2 = flat + off[anchors[j]];
      float d = kt::pair_distance(s1, len[i], s2, len[anchors[j]]);
      d += kt::length_bias(len[i], len[anchors[j]]);
      out[(int64_t)i * stride + j] = d;
    }
  }
}

extern "C" void kt_aln_pairwise_dist(const uint8_t* gapped, int32_t numseq,
                                     int32_t alnlen, float* dm_out) {
  for (int i = 0; i < numseq; i++) dm_out[(int64_t)i * numseq + i] = 0.0f;
  for (int i = 0; i < numseq - 1; i++) {
    const uint8_t* a = gapped + (int64_t)i * alnlen;
    for (int j = i + 1; j < numseq; j++) {
      const uint8_t* b = gapped + (int64_t)j * alnlen;
      int matches = 0, aligned = 0;
      for (int c = 0; c < alnlen; c++) {
        if (a[c] != (uint8_t)'-' && b[c] != (uint8_t)'-') {
          aligned++;
          if (a[c] == b[c]) matches++;
        }
      }
      float d = aligned == 0 ? 1.0f : 1.0f - (float)matches / (float)aligned;
      dm_out[(int64_t)i * numseq + j] = d;
      dm_out[(int64_t)j * numseq + i] = d;
    }
  }
}
