/* Internal interfaces of the native Gotoh/Hirschberg engine. */
#ifndef KT_GOTOH_H
#define KT_GOTOH_H

#include <cstdint>
#include <vector>

namespace kt {

/* scoring parameters for one merge (possibly distance-scaled copies
   of the base params; see aln_run.c:226-237) */
struct Params {
  const float* subm = nullptr; /* 23x23 row-major */
  float gpo = 0.0f;
  float gpe = 0.0f;
  float tgpe = 0.0f;
  float soff = 0.0f; /* VSM substitution offset */
};

/* DP working memory + window state for one alignment job. */
struct AlnMem {
  std::vector<float> fa, fga, fgb; /* forward  match / gap-row / gap-col */
  std::vector<float> ba, bga, bgb; /* backward */
  std::vector<int> path, tmp_path;

  const Params* pr = nullptr;
  const uint8_t* seq1 = nullptr;
  const uint8_t* seq2 = nullptr;
  const float* prof1 = nullptr;
  const float* prof2 = nullptr;
  int sip = 0;

  int starta = 0, enda = 0, startb = 0, endb = 0;
  int starta2 = 0, enda2 = 0;
  int len_a = 0, len_b = 0;

  const float* bonus = nullptr; /* consistency bonus, row-major */
  int64_t bstride = 0;

  /* meet margins + flip perturbation */
  float margin_sum = 0.0f;
  int margin_count = 0;
  float flip_threshold = 0.0f;
  int flip_trial = 0;
  int flip_stride = 1;
  int flip_counter = 0;
  uint32_t flip_mask = 0;
  const int* flip_bit_map = nullptr;
  int flip_n_uncertain = 0;
  float* flip_margins = nullptr;
  int flip_margin_alloc = 0;

  int score_only = 0;
  float score = 0.0f;

  void ensure(int la, int lb);
  void init_window();
};

void run_align(AlnMem& m);
void mirror_path(AlnMem& m, int len_a, int len_b);
void path_to_steps_default(AlnMem& m);
void path_to_steps_fixed(AlnMem& m);

/* profile ops (kt_profile.cpp) */
std::vector<float> leaf_profile(const Params& pr, const uint8_t* seq, int len);
void scale_gap_penalties(float* prof, int len, int nsip);
std::vector<float> merge_profiles(const float* pa, const float* pb,
                                  const Params& base, const int* path,
                                  int sipa, int sipb, float use_seq_weights);
void weave_gaps(const int* path, std::vector<std::vector<int>>& gaps,
                const std::vector<int>& members_a,
                const std::vector<int>& members_b);
float sp_score_groups(const std::vector<const uint8_t*>& seqs,
                      const std::vector<int>& lens,
                      const std::vector<std::vector<int>>& gaps,
                      const Params& pr, const int* path,
                      const std::vector<int>& sip_a,
                      const std::vector<int>& sip_b);

}  // namespace kt

#endif
