/* Profile construction / merging, gap weaving, SP scoring.
 *
 * Profile layout matches the reference's 64-float-per-column format
 * (make_profile_n, lib/src/aln_setup.c:40-99):
 *   [0..22]  weighted residue counts
 *   [23..25] gap open / extension / terminal-gap event counts
 *   [27..29] nsip-scaled gap penalties (filled by scale_gap_penalties)
 *   [32..54] precomputed substitution row sum(freq * subm) - soff
 *   [55..57] base -gpo / -gpe / -tgpe
 * Columns 0 and len+1 are boundary rows.
 */
#include "kt_gotoh.h"

#include <cstring>

namespace kt {

std::vector<float> leaf_profile(const Params& pr, const uint8_t* seq, int len) {
  std::vector<float> prof((size_t)(len + 2) * 64, 0.0f);
  float* last = prof.data() + (size_t)64 * (len + 1);
  last[55] = -pr.gpo;
  last[56] = -pr.gpe;
  last[57] = -pr.tgpe;
  for (int i = 0; i < len; i++) {
    float* col = prof.data() + (size_t)64 * (i + 1);
    const int c = seq[i];
    col[c] += 1.0f; /* leaf weight is always 1 (aln_run.c:205-211) */
    const float* srow = pr.subm + 23 * c;
    for (int j = 22; j >= 0; j--) {
      col[32 + j] = srow[j] - pr.soff;
    }
    col[55] = -pr.gpo;
    col[56] = -pr.gpe;
    col[57] = -pr.tgpe;
  }
  float* first = prof.data();
  first[55] = -pr.gpo;
  first[56] = -pr.gpe;
  first[57] = -pr.tgpe;
  return prof;
}

void scale_gap_penalties(float* prof, int len, int nsip) {
  /* set_gap_penalties_n (aln_setup.c:101-119) */
  for (int i = 0; i <= len + 1; i++) {
    float* col = prof + (size_t)64 * i;
    col[27] = col[55] * (float)nsip;
    col[28] = col[56] * (float)nsip;
    col[29] = col[57] * (float)nsip;
  }
}

std::vector<float> merge_profiles(const float* pa, const float* pb,
                                  const Params& base, const int* path,
                                  int sipa, int sipb, float use_seq_weights) {
  /* update_n (aln_setup.c:230-436), including the optional pseudocount
     rebalancing of residue frequencies with substitution-row delta
     correction */
  const int plen = path[0];
  std::vector<float> out((size_t)(plen + 2) * 64, 0.0f);
  float* np = out.data();

  float scaleA = 1.0f, scaleB = 1.0f;
  int rebalance = 0;
  if (use_seq_weights > 0.0f && sipa > 0 && sipb > 0) {
    float pseudo = use_seq_weights;
    float total = (float)(sipa + sipb);
    float denom = total + 2.0f * pseudo;
    scaleA = total * ((float)sipa + pseudo) / (denom * (float)sipa);
    scaleB = total * ((float)sipb + pseudo) / (denom * (float)sipb);
    rebalance = 1;
  }

  auto combine_boundary = [&](float* dst, const float* a, const float* b) {
    if (rebalance) {
      for (int i = 0; i < 23; i++) dst[i] = a[i] * scaleA + b[i] * scaleB;
      for (int i = 23; i < 64; i++) dst[i] = a[i] + b[i];
    } else {
      for (int i = 63; i >= 0; i--) dst[i] = a[i] + b[i];
    }
  };

  combine_boundary(np, pa, pb);
  pa += 64;
  pb += 64;
  np += 64;

  int c = 1;
  while (path[c] != 3) {
    if (!path[c]) {
      /* match column */
      if (rebalance) {
        for (int i = 0; i < 23; i++) np[i] = pa[i] * scaleA + pb[i] * scaleB;
        for (int i = 23; i < 64; i++) np[i] = pa[i] + pb[i];
        const float dA = scaleA - 1.0f;
        const float dB = scaleB - 1.0f;
        for (int j = 0; j < 23; j++) {
          float delta = 0.0f;
          for (int aa = 0; aa < 23; aa++) {
            delta += (pa[aa] * dA + pb[aa] * dB) * base.subm[23 * aa + j];
          }
          np[32 + j] += delta;
        }
      } else {
        for (int i = 63; i >= 0; i--) np[i] = pa[i] + pb[i];
      }
      pa += 64;
      pb += 64;
    }
    if (path[c] & 1) {
      /* gap in group A: copy B column, charge gap events against A */
      for (int i = 63; i >= 0; i--) np[i] = pb[i];
      pb += 64;
      float gp;
      if (!(path[c] & 20)) {
        if (path[c] & 32) {
          np[25] += (float)sipa;
          gp = base.tgpe * (float)sipa;
        } else {
          np[24] += (float)sipa;
          gp = base.gpe * (float)sipa;
        }
        for (int j = 32; j < 55; j++) np[j] -= gp;
      } else {
        if (path[c] & 16) {
          if (path[c] & 32) {
            np[25] += (float)sipa;
            gp = base.tgpe * (float)sipa;
            np[23] += (float)sipa;
            gp += base.gpo * (float)sipa;
          } else {
            np[23] += (float)sipa;
            gp = base.gpo * (float)sipa;
          }
          for (int j = 32; j < 55; j++) np[j] -= gp;
        }
        if (path[c] & 4) {
          if (path[c] & 32) {
            np[25] += (float)sipa;
            gp = base.tgpe * (float)sipa;
            np[23] += (float)sipa;
            gp += base.gpo * (float)sipa;
          } else {
            np[23] += (float)sipa;
            gp = base.gpo * (float)sipa;
          }
          for (int j = 32; j < 55; j++) np[j] -= gp;
        }
      }
    }
    if (path[c] & 2) {
      /* gap in group B: copy A column, charge gap events against B */
      for (int i = 63; i >= 0; i--) np[i] = pa[i];
      pa += 64;
      float gp;
      if (!(path[c] & 20)) {
        if (path[c] & 32) {
          np[25] += (float)sipb;
          gp = base.tgpe * (float)sipb;
        } else {
          np[24] += (float)sipb;
          gp = base.gpe * (float)sipb;
        }
        for (int j = 32; j < 55; j++) np[j] -= gp;
      } else {
        if (path[c] & 16) {
          if (path[c] & 32) {
            np[25] += (float)sipb;
            gp = base.tgpe * (float)sipb;
            np[23] += (float)sipb;
            gp += base.gpo * (float)sipb;
          } else {
            np[23] += (float)sipb;
            gp = base.gpo * (float)sipb;
          }
          for (int j = 32; j < 55; j++) np[j] -= gp;
        }
        if (path[c] & 4) {
          if (path[c] & 32) {
            np[25] += (float)sipb;
            gp = base.tgpe * (float)sipb;
            np[23] += (float)sipb;
            gp += base.gpo * (float)sipb;
          } else {
            np[23] += (float)sipb;
            gp = base.gpo * (float)sipb;
          }
          for (int j = 32; j < 55; j++) np[j] -= gp;
        }
      }
    }
    np += 64;
    c++;
  }
  combine_boundary(np, pa, pb);
  return out;
}

void weave_gaps(const int* path, std::vector<std::vector<int>>& gaps,
                const std::vector<int>& members_a,
                const std::vector<int>& members_b) {
  /* make_seq + update_gaps (weave_alignment.c:41-112) */
  const int plen = path[0];
  std::vector<int> gap_a(plen + 1, 0), gap_b(plen + 1, 0);
  int posa = 0, posb = 0;
  int c = 1;
  while (path[c] != 3) {
    if (!path[c]) {
      posa++;
      posb++;
    } else if (path[c] & 1) {
      gap_a[posa] += 1;
      posb++;
    } else if (path[c] & 2) {
      gap_b[posb] += 1;
      posa++;
    }
    c++;
  }
  auto apply = [](std::vector<int>& gis, const std::vector<int>& newg) {
    int rel = 0;
    const int old_len = (int)gis.size() - 1;
    for (int i = 0; i <= old_len; i++) {
      int add = 0;
      for (int j = rel; j <= rel + gis[i]; j++) {
        if (newg[j] != 0) add += newg[j];
      }
      rel += gis[i] + 1;
      gis[i] += add;
    }
  };
  for (int i = (int)members_a.size(); i--;) apply(gaps[members_a[i]], gap_a);
  for (int i = (int)members_b.size(); i--;) apply(gaps[members_b[i]], gap_b);
}

float sp_score_groups(const std::vector<const uint8_t*>& seqs,
                      const std::vector<int>& lens,
                      const std::vector<std::vector<int>>& gaps,
                      const Params& pr, const int* path,
                      const std::vector<int>& sip_a,
                      const std::vector<int>& sip_b) {
  /* compute_sp_score (lib/src/sp_score.c:75-201) */
  constexpr int A = 23;
  auto build = [&](const std::vector<int>& sip, int prof_len,
                   std::vector<int>& freq, std::vector<int>& ngap) {
    std::vector<int8_t> cols(prof_len);
    for (int si : sip) {
      int pos = 0;
      for (int j = 0; j < lens[si]; j++) {
        for (int k = 0; k < gaps[si][j]; k++) cols[pos++] = -1;
        cols[pos++] = (int8_t)seqs[si][j];
      }
      for (int k = 0; k < gaps[si][lens[si]]; k++) cols[pos++] = -1;
      for (int j = 0; j < prof_len; j++) {
        if (cols[j] >= 0 && cols[j] < A) {
          freq[(size_t)j * A + cols[j]]++;
        } else {
          ngap[j]++;
        }
      }
    }
  };

  int si = sip_a[0];
  int prof_a_len = lens[si];
  for (int i = 0; i <= lens[si]; i++) prof_a_len += gaps[si][i];
  si = sip_b[0];
  int prof_b_len = lens[si];
  for (int i = 0; i <= lens[si]; i++) prof_b_len += gaps[si][i];

  std::vector<int> freq_a((size_t)prof_a_len * A, 0), ngap_a(prof_a_len, 0);
  std::vector<int> freq_b((size_t)prof_b_len * A, 0), ngap_b(prof_b_len, 0);
  build(sip_a, prof_a_len, freq_a, ngap_a);
  build(sip_b, prof_b_len, freq_b, ngap_b);

  const int nsip_a = (int)sip_a.size();
  const int nsip_b = (int)sip_b.size();
  float total = 0.0f;
  int pos_a = 0, pos_b = 0;
  int in_a_gap = 0, in_b_gap = 0;
  const int path_len = path[0];
  for (int c = 1; c <= path_len; c++) {
    const int step = path[c] & 3;
    const int is_terminal = path[c] & 32;
    const float pen = is_terminal ? pr.tgpe : pr.gpe;
    if (step == 0) {
      const int* fa = freq_a.data() + (size_t)pos_a * A;
      const int* fb = freq_b.data() + (size_t)pos_b * A;
      for (int i = 0; i < A; i++) {
        if (fa[i] == 0) continue;
        for (int j = 0; j < A; j++) {
          if (fb[j] == 0) continue;
          total += (float)(fa[i] * fb[j]) * pr.subm[23 * i + j];
        }
      }
      const int n_res_a = nsip_a - ngap_a[pos_a];
      const int n_gap_b = ngap_b[pos_b];
      const int n_gap_a = ngap_a[pos_a];
      const int n_res_b = nsip_b - ngap_b[pos_b];
      total -= (float)(n_res_a * n_gap_b + n_gap_a * n_res_b) * pen;
      in_a_gap = 0;
      in_b_gap = 0;
      pos_a++;
      pos_b++;
    } else if (step == 1) {
      const int n_res_b = nsip_b - ngap_b[pos_b];
      const int n_pairs = nsip_a * n_res_b;
      if (!in_a_gap) total -= (float)n_pairs * pr.gpo;
      total -= (float)n_pairs * pen;
      in_a_gap = 1;
      in_b_gap = 0;
      pos_b++;
    } else if (step == 2) {
      const int n_res_a = nsip_a - ngap_a[pos_a];
      const int n_pairs = n_res_a * nsip_b;
      if (!in_b_gap) total -= (float)n_pairs * pr.gpo;
      total -= (float)n_pairs * pen;
      in_a_gap = 0;
      in_b_gap = 1;
      pos_a++;
    }
  }
  return total;
}

}  // namespace kt
