/* Granular single-merge entry points for differential testing of the
 * TPU engine against the exact host implementation: one Hirschberg
 * alignment (kt_gotoh.cpp run_align) and the profile build/merge
 * helpers, exposed over the C ABI so tests can drive them directly on
 * arbitrary inputs (reference semantics: lib/src/aln_controller.c,
 * aln_setup.c).
 */
#include "kt_api.h"
#include "kt_gotoh.h"

#include <cstring>
#include <vector>

extern "C" int32_t kt_run_align_single(
    int32_t mode, const uint8_t* seq1, const uint8_t* seq2,
    const float* prof1, const float* prof2, int32_t len_a, int32_t len_b,
    int32_t sip, const float* subm, float gpo, float gpe, float tgpe,
    float soff, const float* bonus, int64_t bstride, float flip_threshold,
    int32_t flip_trial, int32_t flip_stride, uint32_t flip_mask,
    int32_t* path_out, float* info_out) {
  kt::Params pr;
  pr.subm = subm;
  pr.gpo = gpo;
  pr.gpe = gpe;
  pr.tgpe = tgpe;
  pr.soff = soff;

  kt::AlnMem m;
  m.pr = &pr;
  m.ensure(len_a, len_b);
  m.init_window();
  m.bonus = bonus;
  m.bstride = bstride;
  m.flip_threshold = flip_threshold;
  m.flip_trial = flip_trial;
  m.flip_stride = flip_stride;
  m.flip_counter = 0;
  m.flip_mask = flip_mask;
  m.margin_sum = 0.0f;
  m.margin_count = 0;
  m.sip = sip;
  if (mode == 0) { /* residues x residues */
    m.seq1 = seq1;
    m.seq2 = seq2;
    m.prof1 = nullptr;
    m.prof2 = nullptr;
  } else if (mode == 1) { /* profile x residues */
    m.seq1 = nullptr;
    m.seq2 = seq2;
    m.prof1 = prof1;
    m.prof2 = nullptr;
  } else { /* profile x profile */
    m.seq1 = nullptr;
    m.seq2 = nullptr;
    m.prof1 = prof1;
    m.prof2 = prof2;
  }
  kt::run_align(m);
  for (int i = 0; i < len_a + 2; i++) path_out[i] = m.path[i];
  if (info_out) {
    info_out[0] = m.margin_sum;
    info_out[1] = (float)m.margin_count;
    info_out[2] = m.score;
  }
  return 0;
}

extern "C" void kt_leaf_profile(const float* subm, float gpo, float gpe,
                                float tgpe, const uint8_t* seq, int32_t len,
                                float* out) {
  kt::Params pr;
  pr.subm = subm;
  pr.gpo = gpo;
  pr.gpe = gpe;
  pr.tgpe = tgpe;
  std::vector<float> p = kt::leaf_profile(pr, seq, len);
  std::memcpy(out, p.data(), p.size() * sizeof(float));
}

extern "C" void kt_scale_gaps(float* prof, int32_t len, int32_t nsip) {
  kt::scale_gap_penalties(prof, len, nsip);
}

extern "C" int32_t kt_merge_profiles(const float* pa, const float* pb,
                                     const float* subm, float gpo, float gpe,
                                     float tgpe, const int32_t* path,
                                     int32_t sipa, int32_t sipb,
                                     float use_seq_weights, float* out) {
  kt::Params pr;
  pr.subm = subm;
  pr.gpo = gpo;
  pr.gpe = gpe;
  pr.tgpe = tgpe;
  std::vector<int> p(path, path + path[0] + 2);
  std::vector<float> merged =
      kt::merge_profiles(pa, pb, pr, p.data(), sipa, sipb, use_seq_weights);
  std::memcpy(out, merged.data(), merged.size() * sizeof(float));
  return path[0];
}
