/* Progressive alignment driver: per-merge profile management, distance-
 * dependent parameter scaling (gap scale + MAFFT-style VSM offset),
 * anchor-consistency bonuses, inline and two-pass refinement.
 *
 * Mirrors the orchestration in lib/src/aln_run.c (create_msa_tree /
 * do_align / inline refine), lib/src/aln_refine.c (two-pass refinement)
 * and lib/src/anchor_consistency.c, preserving float accumulation order
 * (e.g. the reversed sip member ordering from aln_run.c:428-436 feeds
 * the scaling sums in aln_run.c:126-203).
 */
#include "kt_api.h"
#include "kt_gotoh.h"

#include <algorithm>
#include <array>
#ifdef _OPENMP
#include <omp.h>
#endif
#include <cfloat>
#include <cmath>
#include <cstring>
#include <memory>
#include <vector>

namespace kt {
namespace {

constexpr int kRefineTrials = 5; /* REFINE_N_TRIALS (aln_refine.c:20) */

/* Pluggable DP backend (kt_api.h).  When set, every full-path alignment
 * (merges and consistency pairwise maps) goes through it instead of the
 * in-process Hirschberg; orchestration stays here. */
kt_dp_fn g_dp_hook = nullptr;
kt_pairwise_fn g_pairwise_hook = nullptr;
kt_merge_batch_fn g_merge_batch_hook = nullptr;
kt_trial_batch_fn g_trial_batch_hook = nullptr;
int g_dp_error = 0;

void invoke_dp(AlnMem& m) {
  /* bitmap/mask flip modes are not part of the hook ABI (unused by this
     driver); keep them on the native path. */
  if (!g_dp_hook || m.flip_bit_map || m.flip_mask) {
    run_align(m);
    return;
  }
  if (g_dp_error) return;
  int mode = m.seq1 ? 0 : (m.prof2 ? 2 : 1);
  float info[2] = {0.0f, 0.0f};
  int rc = g_dp_hook(mode, m.seq1, m.seq2, m.prof1, m.prof2, m.len_a, m.len_b,
                     m.sip, m.pr->subm, m.pr->gpo, m.pr->gpe, m.pr->tgpe,
                     m.pr->soff, m.bonus, m.bstride, m.flip_threshold,
                     m.flip_trial, m.flip_stride, m.path.data(), info,
                     m.flip_margins, m.flip_margin_alloc);
  if (rc != 0) {
    g_dp_error = 1;
    return;
  }
  m.margin_sum = info[0];
  m.margin_count = (int)info[1];
}

struct ConsistencyTable {
  int K = 0;
  int numseq = 0;
  float weight = 0.0f;
  std::vector<int> anchor_ids;
  /* pos_maps[i*K+k][p] = anchor position aligned to residue p of seq i */
  std::vector<std::vector<int>> pos_maps;
};

struct Engine {
  int numseq = 0;
  std::vector<const uint8_t*> seqs;
  std::vector<int> lens;
  std::vector<std::vector<int>> gaps;
  std::vector<std::vector<int>> sip;
  std::vector<int> nsip;
  std::vector<int> plen;
  std::vector<std::vector<float>> profiles;
  std::vector<std::array<int, 3>> tasks; /* sorted ascending by c */
  std::vector<float> confidence;

  Params base;
  float dist_scale = 0.0f;
  float vsm_amax = 0.0f;
  float use_seq_weights = 0.0f;
  const float* seq_distances = nullptr;
  int adaptive_budget = 0;

  std::unique_ptr<ConsistencyTable> ct;

  AlnMem mem;

  /* --- distance-dependent scaling (aln_run.c:126-203) --- */
  float cluster_avg_div(int a, int b, int* count_out) const {
    float sum = 0.0f;
    int count = 0;
    for (int si : sip[a]) {
      if (si < numseq) {
        sum += seq_distances[si];
        count++;
      }
    }
    for (int si : sip[b]) {
      if (si < numseq) {
        sum += seq_distances[si];
        count++;
      }
    }
    *count_out = count;
    return count ? sum / (float)count : 0.0f;
  }

  float gap_scale(int a, int b) const {
    if (dist_scale <= 0.0f || seq_distances == nullptr) return 1.0f;
    int count;
    float avg = cluster_avg_div(a, b, &count);
    if (count == 0) return 1.0f;
    float scale = 1.0f - dist_scale * avg;
    if (scale < 0.3f) scale = 0.3f;
    if (scale > 1.0f) scale = 1.0f;
    return scale;
  }

  float subm_offset(int a, int b) const {
    if (vsm_amax <= 0.0f || seq_distances == nullptr) return 0.0f;
    int count;
    float avg = cluster_avg_div(a, b, &count);
    if (count == 0) return 0.0f;
    float off = vsm_amax - avg;
    return off < 0.0f ? 0.0f : off;
  }

  Params effective_params(int a, int b, bool* scaled) const {
    float gs = gap_scale(a, b);
    float so = subm_offset(a, b);
    Params p = base;
    if (gs < 1.0f || so > 0.0f) {
      p.gpo = base.gpo * gs;
      p.gpe = base.gpe * gs;
      p.tgpe = base.tgpe * gs;
      p.soff = so;
      *scaled = true;
    } else {
      *scaled = false;
    }
    return p;
  }

  /* --- consistency bonus --- */

  void node_anchor_positions(int node, int dp_len, int k,
                             std::vector<int>& pos,
                             std::vector<float>& conf) const {
    /* get_node_anchor_positions (anchor_consistency.c:352-467) */
    const int K = ct->K;
    if (nsip[node] == 1) {
      const std::vector<int>& map = ct->pos_maps[(size_t)node * K + k];
      int seq_len = lens[node];
      int i = 0;
      for (; i < dp_len && i < seq_len; i++) {
        pos[i] = map[i];
        conf[i] = map[i] >= 0 ? 1.0f : 0.0f;
      }
      for (; i < dp_len; i++) {
        pos[i] = -1;
        conf[i] = 0.0f;
      }
      return;
    }
    std::vector<int> col_to_ungapped(dp_len + 1);
    std::vector<int> best_pos(dp_len, -1), agree(dp_len, 0), total(dp_len, 0);
    for (int si : sip[node]) {
      if (si >= ct->numseq) continue;
      const std::vector<int>& map = ct->pos_maps[(size_t)si * K + k];
      const int seq_len = lens[si];
      const std::vector<int>& g = gaps[si];
      int col = 0;
      for (int p = 0; p <= seq_len && col < dp_len; p++) {
        for (int gg = 0; gg < g[p] && col < dp_len; gg++) {
          col_to_ungapped[col++] = -1;
        }
        if (p < seq_len && col < dp_len) col_to_ungapped[col++] = p;
      }
      while (col < dp_len) col_to_ungapped[col++] = -1;
      for (int c = 0; c < dp_len; c++) {
        int ugp = col_to_ungapped[c];
        if (ugp < 0 || ugp >= seq_len) continue;
        int apos = map[ugp];
        if (apos < 0) continue;
        total[c]++;
        if (best_pos[c] < 0) {
          best_pos[c] = apos;
          agree[c] = 1;
        } else if (apos == best_pos[c]) {
          agree[c]++;
        }
      }
    }
    for (int c = 0; c < dp_len; c++) {
      if (total[c] > 0 && agree[c] > 0) {
        pos[c] = best_pos[c];
        conf[c] = (float)agree[c] / (float)total[c];
      } else {
        pos[c] = -1;
        conf[c] = 0.0f;
      }
    }
  }

  std::vector<float> bonus_matrix(int node_a, int len_a, int node_b,
                                  int len_b) const {
    /* anchor_consistency_get_bonus_profile (anchor_consistency.c:469-561).
       One guard element appended: the reference DP reads one float past
       the matrix at the bottom-right boundary cell. */
    std::vector<float> bonus((size_t)len_a * len_b + 1, 0.0f);
    const int K = ct->K;
    const float per_w = ct->weight / (float)K;
    std::vector<int> apos_a(len_a), apos_b(len_b);
    std::vector<float> conf_a(len_a), conf_b(len_b);
    for (int k = 0; k < K; k++) {
      node_anchor_positions(node_a, len_a, k, apos_a, conf_a);
      node_anchor_positions(node_b, len_b, k, apos_b, conf_b);
      int anchor_len = 0;
      for (int i = 0; i < len_a; i++) {
        if (apos_a[i] >= anchor_len) anchor_len = apos_a[i] + 1;
      }
      for (int j = 0; j < len_b; j++) {
        if (apos_b[j] >= anchor_len) anchor_len = apos_b[j] + 1;
      }
      if (anchor_len == 0) continue;
      std::vector<int> inv_b(anchor_len, -1);
      std::vector<float> inv_conf_b(anchor_len, 0.0f);
      for (int j = 0; j < len_b; j++) {
        if (apos_b[j] >= 0 && apos_b[j] < anchor_len) {
          inv_b[apos_b[j]] = j;
          inv_conf_b[apos_b[j]] = conf_b[j];
        }
      }
      for (int i = 0; i < len_a; i++) {
        int ak = apos_a[i];
        if (ak >= 0 && ak < anchor_len) {
          int bj = inv_b[ak];
          if (bj >= 0) {
            bonus[(size_t)i * len_b + bj] += per_w * conf_a[i] * inv_conf_b[ak];
          }
        }
      }
    }
    return bonus;
  }

  /* pick DP row/col nodes by the shorter-first rules shared by
     do_align / refine (aln_run.c:262-295) */
  void pick_bonus_sides(int a, int b, int len_a, int len_b, int* row_node,
                        int* rows, int* col_node, int* cols) const {
    if (nsip[a] == 1 && nsip[b] == 1) {
      if (len_a < len_b) {
        *row_node = a; *rows = len_a; *col_node = b; *cols = len_b;
      } else {
        *row_node = b; *rows = len_b; *col_node = a; *cols = len_a;
      }
    } else if (nsip[a] == 1) {
      *row_node = b; *rows = len_b; *col_node = a; *cols = len_a;
    } else if (nsip[b] == 1) {
      *row_node = a; *rows = len_a; *col_node = b; *cols = len_b;
    } else {
      if (len_a < len_b) {
        *row_node = a; *rows = len_a; *col_node = b; *cols = len_b;
      } else {
        *row_node = b; *rows = len_b; *col_node = a; *cols = len_a;
      }
    }
  }

  /* operand orientation shared by the per-merge dispatch and the
     level-batch path (aln_run.c:297-388 rules) */
  struct Orient {
    int mode;              /* 0 rr, 1 pr, 2 pp */
    const uint8_t* s1 = nullptr;
    const uint8_t* s2 = nullptr;
    const float* p1 = nullptr;
    const float* p2 = nullptr;
    int rows, cols, sip;
    bool swapped;          /* mirror path back to (len_a, len_b) after */
  };

  Orient orient_merge(int a, int b, int len_a, int len_b) const {
    Orient o{};
    if (nsip[a] == 1) {
      if (nsip[b] == 1) {
        o.mode = 0;
        if (len_a < len_b) {
          o.s1 = seqs[a]; o.s2 = seqs[b];
          o.rows = len_a; o.cols = len_b; o.swapped = false;
        } else {
          o.s1 = seqs[b]; o.s2 = seqs[a];
          o.rows = len_b; o.cols = len_a; o.swapped = true;
        }
      } else {
        o.mode = 1;
        o.p1 = profiles[b].data(); o.s2 = seqs[a];
        o.rows = len_b; o.cols = len_a; o.sip = nsip[b]; o.swapped = true;
      }
    } else {
      if (nsip[b] == 1) {
        o.mode = 1;
        o.p1 = profiles[a].data(); o.s2 = seqs[b];
        o.rows = len_a; o.cols = len_b; o.sip = nsip[a]; o.swapped = false;
      } else {
        o.mode = 2;
        if (len_a < len_b) {
          o.p1 = profiles[a].data(); o.p2 = profiles[b].data();
          o.rows = len_a; o.cols = len_b; o.swapped = false;
        } else {
          o.p1 = profiles[b].data(); o.p2 = profiles[a].data();
          o.rows = len_b; o.cols = len_a; o.swapped = true;
        }
      }
    }
    return o;
  }

  /* dispatch one DP run with operand ordering + mirroring
     (aln_run.c:297-388 / aln_refine.c:501-578); orientation comes from
     orient_merge — the single source of the ordering rules shared with
     the level-batch path */
  void dispatch_mt(int a, int b, int len_a, int len_b, AlnMem& mem) {
    Orient o = orient_merge(a, b, len_a, len_b);
    mem.seq1 = o.s1;
    mem.seq2 = o.s2;
    mem.prof1 = o.p1;
    mem.prof2 = o.p2;
    mem.sip = o.sip;
    if (o.swapped) {
      mem.enda = o.rows;
      mem.endb = o.cols;
      mem.len_a = o.rows;
      mem.len_b = o.cols;
    }
    invoke_dp(mem);
    if (o.swapped) {
      mirror_path(mem, len_a, len_b);
      mem.len_a = len_a;
      mem.len_b = len_b;
    }
  }

  void finish_merge_mt(int task_id, int a, int b, int c, AlnMem& mem) {
    const int* path = mem.path.data();
    if (task_id != (int)tasks.size() - 1) {
      profiles[c] = merge_profiles(profiles[a].data(), profiles[b].data(),
                                   base, path, nsip[a], nsip[b],
                                   use_seq_weights);
    } else {
      profiles[c].assign((size_t)(path[0] + 2) * 64, 0.0f);
    }
    profiles[a].clear();
    profiles[a].shrink_to_fit();
    profiles[b].clear();
    profiles[b].shrink_to_fit();
    weave_gaps(path, gaps, sip[a], sip[b]);
    plen[c] = path[0];
    nsip[c] = nsip[a] + nsip[b];
    sip[c].clear();
    for (int j = (int)sip[a].size(); j--;) sip[c].push_back(sip[a][j]);
    for (int j = (int)sip[b].size(); j--;) sip[c].push_back(sip[b][j]);
  }

  void prepare_profiles(const Params& eff, int a, int b, int* len_a,
                        int* len_b) {
    if (nsip[a] == 1) {
      *len_a = lens[a];
      profiles[a] = leaf_profile(eff, seqs[a], *len_a);
    } else {
      *len_a = plen[a];
      scale_gap_penalties(profiles[a].data(), *len_a, nsip[b]);
    }
    if (nsip[b] == 1) {
      *len_b = lens[b];
      profiles[b] = leaf_profile(eff, seqs[b], *len_b);
    } else {
      *len_b = plen[b];
      scale_gap_penalties(profiles[b].data(), *len_b, nsip[a]);
    }
  }

  void setup_bonus_mt(int a, int b, int len_a, int len_b,
                      std::vector<float>& bonus_store, AlnMem& mem) {
    mem.bonus = nullptr;
    mem.bstride = 0;
    if (!ct) return;
    int rn, rows, cn, cols;
    pick_bonus_sides(a, b, len_a, len_b, &rn, &rows, &cn, &cols);
    bonus_store = bonus_matrix(rn, rows, cn, cols);
    mem.bonus = bonus_store.data();
    mem.bstride = cols;
  }

  void dispatch(int a, int b, int len_a, int len_b) {
    dispatch_mt(a, b, len_a, len_b, mem);
  }
  void setup_bonus(int a, int b, int len_a, int len_b,
                   std::vector<float>& bonus_store) {
    setup_bonus_mt(a, b, len_a, len_b, bonus_store, mem);
  }
  void finish_merge(int task_id, int a, int b, int c) {
    finish_merge_mt(task_id, a, b, c, mem);
  }

  /* trials 1..n_trials-1 through the batched backend; fills
     per-trial raw paths + margins for the SP-selection loop.  The
     operands/orientation mirror dispatch_mt via orient_merge. */
  bool run_trials_batched(int a, int b, int len_a, int len_b,
                          const Params& eff, const float* bonus,
                          int64_t bstride, int n_trials, float threshold,
                          std::vector<int>& trial_paths, int64_t& stride,
                          std::vector<float>& msums,
                          std::vector<int32_t>& mcounts, Orient& o) {
    if (!g_trial_batch_hook || n_trials <= 1) return false;
    o = orient_merge(a, b, len_a, len_b);
    stride = o.rows + 2;
    const int K = n_trials - 1;
    trial_paths.assign((size_t)K * stride, -1);
    msums.assign(K, 0.0f);
    mcounts.assign(K, 0);
    int rc = g_trial_batch_hook(
        o.mode, o.s1, o.s2, o.p1, o.p2, o.rows, o.cols, o.sip, base.subm,
        eff.gpo, eff.gpe, eff.tgpe, eff.soff, bonus, bstride, n_trials,
        threshold, n_trials - 1, trial_paths.data(), stride, msums.data(),
        mcounts.data());
    if (rc != 0) {
      g_dp_error = 1;
      return false;
    }
    return true;
  }

  void reset_trial(int len_a, int len_b) {
    int g = (len_a > len_b ? len_a : len_b) + 2;
    for (int i = 0; i < g; i++) mem.path[i] = -1;
    mem.starta = 0;
    mem.startb = 0;
    mem.enda = len_a;
    mem.endb = len_b;
    mem.len_a = len_a;
    mem.len_b = len_b;
    mem.fa[0] = 0.0f;
    mem.fga[0] = -FLT_MAX;
    mem.fgb[0] = -FLT_MAX;
    mem.ba[0] = 0.0f;
    mem.bga[0] = -FLT_MAX;
    mem.bgb[0] = -FLT_MAX;
    mem.margin_sum = 0.0f;
    mem.margin_count = 0;
  }

  /* standard single-trial merge (do_align, aln_run.c:213-441).
     Thread-safe across edges of one tree level: every touched node
     (a, b, c and their member sequences) is disjoint between edges. */
  void align_edge_mt(int task_id, AlnMem& m) {
    if (g_dp_error) return;
    const int a = tasks[task_id][0];
    const int b = tasks[task_id][1];
    const int c = tasks[task_id][2];
    bool scaled;
    Params eff = effective_params(a, b, &scaled);
    m.pr = &eff;

    int len_a, len_b;
    prepare_profiles(eff, a, b, &len_a, &len_b);
    m.ensure(len_a, len_b);
    m.init_window();
    m.margin_sum = 0.0f;
    m.margin_count = 0;
    m.flip_threshold = 0.0f;
    m.flip_trial = 0;
    std::vector<float> bonus_store;
    setup_bonus_mt(a, b, len_a, len_b, bonus_store, m);

    dispatch_mt(a, b, len_a, len_b, m);
    if (g_dp_error) return;

    confidence[task_id] =
        m.margin_count > 0 ? m.margin_sum / (float)m.margin_count : 0.0f;
    path_to_steps_default(m);
    m.bonus = nullptr;
    finish_merge_mt(task_id, a, b, c, m);
  }

  void align_edge(int task_id) { align_edge_mt(task_id, mem); }

  /* inline refine: n trials per merge, keep best SP
     (do_align_inline_refine, aln_run.c:514-784) */
  void align_edge_inline(int task_id, int n_trials) {
    if (g_dp_error) return;
    const int a = tasks[task_id][0];
    const int b = tasks[task_id][1];
    const int c = tasks[task_id][2];
    bool scaled;
    Params eff = effective_params(a, b, &scaled);
    mem.pr = &eff;

    int len_a, len_b;
    prepare_profiles(eff, a, b, &len_a, &len_b);
    mem.ensure(len_a, len_b);
    mem.init_window();
    std::vector<float> bonus_store;
    setup_bonus(a, b, len_a, len_b, bonus_store);

    std::vector<int> best_path;
    float best_sp = -FLT_MAX;
    float avg_margin = 0.0f;
    for (int k = 0; k < n_trials; k++) {
      reset_trial(len_a, len_b);
      if (k == 0) {
        mem.flip_threshold = 0.0f;
        mem.flip_trial = 0;
      } else {
        mem.flip_threshold = avg_margin;
        mem.flip_trial = k;
        mem.flip_stride = n_trials - 1;
        mem.flip_counter = 0;
      }
      dispatch(a, b, len_a, len_b);
      if (g_dp_error) return;
      path_to_steps_default(mem);
      float sp = sp_score_groups(seqs, lens, gaps, eff, mem.path.data(),
                                 sip[a], sip[b]);
      if (sp > best_sp) {
        best_sp = sp;
        best_path.assign(mem.path.begin(),
                         mem.path.begin() + (mem.path[0] + 2));
      }
      if (k == 0 && mem.margin_count > 0) {
        avg_margin = mem.margin_sum / (float)mem.margin_count;
      }
    }
    std::copy(best_path.begin(), best_path.end(), mem.path.begin());
    mem.bonus = nullptr;
    confidence[task_id] = best_sp;
    finish_merge(task_id, a, b, c);
  }

  /* two-pass refinement edge (refine_edge, aln_refine.c:88-346) */
  void refine_edge(int task_id) {
    if (g_dp_error) return;
    const int a = tasks[task_id][0];
    const int b = tasks[task_id][1];
    const int c = tasks[task_id][2];
    bool scaled;
    Params eff = effective_params(a, b, &scaled);
    mem.pr = &eff;

    int len_a, len_b;
    prepare_profiles(eff, a, b, &len_a, &len_b);
    mem.ensure(len_a, len_b);
    mem.init_window();
    mem.margin_sum = 0.0f;
    mem.margin_count = 0;
    std::vector<float> bonus_store;
    setup_bonus(a, b, len_a, len_b, bonus_store);

    std::vector<float> margin_log;
    if (adaptive_budget) {
      int est = std::min(len_a, len_b) + 1;
      if (est < 64) est = 64;
      margin_log.resize(est);
      mem.flip_margins = margin_log.data();
      mem.flip_margin_alloc = est;
    }

    int n_trials = kRefineTrials;
    std::vector<int> best_path;
    float best_sp = -FLT_MAX;
    float best_margin_sum = 0.0f;
    int best_margin_count = 0;
    float avg_margin = 0.0f;
    std::vector<int> trial_paths;
    std::vector<float> trial_msums;
    std::vector<int32_t> trial_mcounts;
    int64_t trial_stride = 0;
    bool batched = false;
    Orient batch_o{};
    for (int k = 0; k < n_trials; k++) {
      if (batched) {
        /* trial k's raw path from the batched run, mirrored exactly
           as dispatch would */
        reset_trial(len_a, len_b);
        mem.ensure(batch_o.rows, batch_o.cols);
        std::copy(trial_paths.begin() + (size_t)(k - 1) * trial_stride,
                  trial_paths.begin() + (size_t)(k - 1) * trial_stride +
                      batch_o.rows + 2,
                  mem.path.begin());
        if (batch_o.swapped) {
          mem.len_a = batch_o.rows;
          mem.len_b = batch_o.cols;
          mirror_path(mem, len_a, len_b);
        }
        mem.len_a = len_a;
        mem.len_b = len_b;
        mem.margin_sum = trial_msums[k - 1];
        mem.margin_count = trial_mcounts[k - 1];
      } else {
        reset_trial(len_a, len_b);
        if (k == 0) {
          mem.flip_threshold = 0.0f;
          mem.flip_trial = 0;
        } else {
          mem.flip_threshold = avg_margin;
          mem.flip_trial = k;
          mem.flip_stride = n_trials - 1;
          mem.flip_counter = 0;
        }
        dispatch(a, b, len_a, len_b);
        if (g_dp_error) return;
      }
      path_to_steps_fixed(mem);
      float sp = sp_score_groups(seqs, lens, gaps, eff, mem.path.data(),
                                 sip[a], sip[b]);
      if (sp > best_sp) {
        best_sp = sp;
        best_margin_sum = mem.margin_sum;
        best_margin_count = mem.margin_count;
        best_path.assign(mem.path.begin(),
                         mem.path.begin() + (mem.path[0] + 2));
      }
      if (k == 0) {
        if (mem.margin_count > 0) {
          avg_margin = mem.margin_sum / (float)mem.margin_count;
        }
        if (adaptive_budget && mem.flip_margins && mem.margin_count > 0) {
          int n_vu = 0;
          float vu_thr = avg_margin * 0.25f;
          for (int mi = 0; mi < mem.margin_count; mi++) {
            if (mem.flip_margins[mi] < vu_thr) n_vu++;
          }
          float frac = (float)n_vu / (float)mem.margin_count;
          n_trials = 1 + (int)(7.0f * frac + 0.5f);
        }
        mem.flip_margins = nullptr;
        mem.flip_margin_alloc = 0;
        if (avg_margin > 0.0f) {
          batched = run_trials_batched(
              a, b, len_a, len_b, eff, mem.bonus, mem.bstride, n_trials,
              avg_margin, trial_paths, trial_stride, trial_msums,
              trial_mcounts, batch_o);
          if (g_dp_error) return;
        }
      }
    }
    std::copy(best_path.begin(), best_path.end(), mem.path.begin());
    mem.bonus = nullptr;
    confidence[task_id] = best_margin_count > 0
                              ? best_margin_sum / (float)best_margin_count
                              : 0.0f;
    finish_merge(task_id, a, b, c);
  }

  /* replay edge during two-pass refinement (replay_edge,
     aln_refine.c:351-497) — single trial, fixed path converter */
  void replay_edge(int task_id) {
    if (g_dp_error) return;
    const int a = tasks[task_id][0];
    const int b = tasks[task_id][1];
    const int c = tasks[task_id][2];
    bool scaled;
    Params eff = effective_params(a, b, &scaled);
    mem.pr = &eff;

    int len_a, len_b;
    prepare_profiles(eff, a, b, &len_a, &len_b);
    mem.ensure(len_a, len_b);
    mem.init_window();
    mem.margin_sum = 0.0f;
    mem.margin_count = 0;
    mem.flip_threshold = 0.0f;
    mem.flip_trial = 0;
    std::vector<float> bonus_store;
    setup_bonus(a, b, len_a, len_b, bonus_store);

    dispatch(a, b, len_a, len_b);
    if (g_dp_error) return;
    mem.bonus = nullptr;
    confidence[task_id] =
        mem.margin_count > 0 ? mem.margin_sum / (float)mem.margin_count : 0.0f;
    path_to_steps_fixed(mem);
    finish_merge(task_id, a, b, c);
  }

  /* one guide-tree level through the batched merge backend
     (flip-free progressive pass only) */
  void align_level_batched(const std::vector<int>& edge_ids) {
    if (g_dp_error) return;
    const int n = (int)edge_ids.size();
    struct Prep {
      Params eff;
      Orient o;
      std::vector<float> bonus_store;
      const float* bonus = nullptr;
      int64_t bstride = 0;
      int len_a, len_b;
    };
    std::vector<Prep> preps(n);
    for (int e = 0; e < n; e++) {
      const int t = edge_ids[e];
      const int a = tasks[t][0], b = tasks[t][1];
      bool scaled;
      Prep& p = preps[e];
      p.eff = effective_params(a, b, &scaled);
      prepare_profiles(p.eff, a, b, &p.len_a, &p.len_b);
      if (ct) {
        int rn, rows, cn, cols;
        pick_bonus_sides(a, b, p.len_a, p.len_b, &rn, &rows, &cn, &cols);
        p.bonus_store = bonus_matrix(rn, rows, cn, cols);
        p.bonus = p.bonus_store.data();
        p.bstride = cols;
      }
      p.o = orient_merge(a, b, p.len_a, p.len_b);
    }

    int64_t stride = 0;
    for (const auto& p : preps) {
      stride = std::max<int64_t>(stride, p.o.rows + 2);
    }
    std::vector<int> paths((size_t)n * stride, -1);
    std::vector<int32_t> modes(n), la(n), lb(n), sips(n), mcounts(n, 0);
    std::vector<const uint8_t*> sa(n), sb(n);
    std::vector<const float*> pa(n), pb(n), bonuses(n);
    std::vector<int64_t> bstrides(n);
    std::vector<float> gpos(n), gpes(n), tgpes(n), soffs(n), msums(n, 0.0f);
    for (int e = 0; e < n; e++) {
      const Prep& p = preps[e];
      modes[e] = p.o.mode;
      sa[e] = p.o.s1;
      sb[e] = p.o.s2;
      pa[e] = p.o.p1;
      pb[e] = p.o.p2;
      la[e] = p.o.rows;
      lb[e] = p.o.cols;
      sips[e] = p.o.sip;
      bonuses[e] = p.bonus;
      bstrides[e] = p.bstride;
      gpos[e] = p.eff.gpo;
      gpes[e] = p.eff.gpe;
      tgpes[e] = p.eff.tgpe;
      soffs[e] = p.eff.soff;
    }
    int rc = g_merge_batch_hook(
        n, modes.data(), sa.data(), sb.data(), pa.data(), pb.data(),
        la.data(), lb.data(), sips.data(), bonuses.data(), bstrides.data(),
        gpos.data(), gpes.data(), tgpes.data(), soffs.data(), base.subm,
        paths.data(), stride, msums.data(), mcounts.data());
    if (rc != 0) {
      g_dp_error = 1;
      return;
    }

    for (int e = 0; e < n; e++) {
      const int t = edge_ids[e];
      const int a = tasks[t][0], b = tasks[t][1], c = tasks[t][2];
      const Prep& p = preps[e];
      mem.ensure(p.o.rows, p.o.cols);
      mem.init_window();
      std::copy(paths.begin() + (size_t)e * stride,
                paths.begin() + (size_t)e * stride + p.o.rows + 2,
                mem.path.begin());
      if (p.o.swapped) {
        mirror_path(mem, p.len_a, p.len_b);
        mem.len_a = p.len_a;
        mem.len_b = p.len_b;
      }
      confidence[t] = mcounts[e] > 0 ? msums[e] / (float)mcounts[e] : 0.0f;
      path_to_steps_default(mem);
      finish_merge_mt(t, a, b, c, mem);
    }
  }

  void clean_alignment_state() {
    /* clean_aln (weave_alignment.c:10-39) */
    for (int i = 0; i < numseq; i++) {
      std::fill(gaps[i].begin(), gaps[i].end(), 0);
      sip[i] = {i};
      nsip[i] = 1;
    }
    for (int i = numseq; i < 2 * numseq - 1; i++) {
      sip[i].clear();
      nsip[i] = 0;
    }
    for (auto& p : profiles) {
      p.clear();
      p.shrink_to_fit();
    }
  }

  float confidence_median() const {
    std::vector<float> v(confidence);
    /* insertion sort per reference (aln_refine.c:688-697) — any sort
       yields the same order for the median */
    std::sort(v.begin(), v.end());
    int n = (int)v.size();
    if (n % 2 == 0) return (v[n / 2 - 1] + v[n / 2]) / 2.0f;
    return v[n / 2];
  }

  /* consistency table construction (anchor_consistency.c:124-275) */
  void build_consistency(int K, float weight, const float* sd) {
    if (K <= 0 || numseq < 3 || sd == nullptr) return;
    if (K > numseq) K = numseq;
    ct = std::make_unique<ConsistencyTable>();
    ct->K = K;
    ct->numseq = numseq;
    ct->weight = weight;
    ct->anchor_ids.resize(K);
    ct->pos_maps.resize((size_t)numseq * K);

    /* farthest-first anchor selection on seq_distances */
    {
      float sum = 0.0f;
      for (int i = 0; i < numseq; i++) sum += sd[i];
      float mean = sum / (float)numseq;
      float best_diff = FLT_MAX;
      int best_idx = 0;
      for (int i = 0; i < numseq; i++) {
        float diff = sd[i] - mean;
        if (diff < 0) diff = -diff;
        if (diff < best_diff) {
          best_diff = diff;
          best_idx = i;
        }
      }
      ct->anchor_ids[0] = best_idx;
      std::vector<float> min_dist(numseq);
      for (int i = 0; i < numseq; i++) {
        float d = sd[i] - sd[best_idx];
        if (d < 0) d = -d;
        min_dist[i] = d;
      }
      for (int k = 1; k < K; k++) {
        float best_min = -1.0f;
        int bi = 0;
        for (int i = 0; i < numseq; i++) {
          bool skip = false;
          for (int j = 0; j < k; j++) {
            if (ct->anchor_ids[j] == i) {
              skip = true;
              break;
            }
          }
          if (skip) continue;
          if (min_dist[i] > best_min) {
            best_min = min_dist[i];
            bi = i;
          }
        }
        ct->anchor_ids[k] = bi;
        for (int i = 0; i < numseq; i++) {
          float d = sd[i] - sd[bi];
          if (d < 0) d = -d;
          if (d < min_dist[i]) min_dist[i] = d;
        }
      }
    }

    /* position maps via pairwise alignments.  With the batched
       pairwise backend installed, all non-identity pairs go to the
       device in ONE callback (rows = shorter side, mirrored back
       here); otherwise each pair runs through invoke_dp. */
    struct PairJob {
      int i, k, ak;
      bool swapped;
      int rows, cols;
    };
    std::vector<PairJob> jobs;
    for (int i = 0; i < numseq; i++) {
      for (int k = 0; k < K; k++) {
        const int ak = ct->anchor_ids[k];
        std::vector<int>& map = ct->pos_maps[(size_t)i * K + k];
        map.assign(lens[i], -1);
        if (i == ak) {
          for (int p = 0; p < lens[i]; p++) map[p] = p;
          continue;
        }
        PairJob j;
        j.i = i;
        j.k = k;
        j.ak = ak;
        j.swapped = lens[i] > lens[ak];
        j.rows = j.swapped ? lens[ak] : lens[i];
        j.cols = j.swapped ? lens[i] : lens[ak];
        jobs.push_back(j);
      }
    }

    std::vector<int> batch_paths;
    int64_t stride = 0;
    if (g_pairwise_hook && !jobs.empty()) {
      int max_rows = 0;
      for (const auto& j : jobs) max_rows = std::max(max_rows, j.rows);
      stride = max_rows + 2;
      batch_paths.assign((size_t)jobs.size() * stride, -1);
      std::vector<const uint8_t*> sa(jobs.size()), sb(jobs.size());
      std::vector<int32_t> la(jobs.size()), lb(jobs.size());
      for (size_t p = 0; p < jobs.size(); p++) {
        const auto& j = jobs[p];
        sa[p] = j.swapped ? seqs[j.ak] : seqs[j.i];
        sb[p] = j.swapped ? seqs[j.i] : seqs[j.ak];
        la[p] = j.rows;
        lb[p] = j.cols;
      }
      int rc = g_pairwise_hook((int32_t)jobs.size(), sa.data(), la.data(),
                               sb.data(), lb.data(), base.subm, base.gpo,
                               base.gpe, base.tgpe, batch_paths.data(),
                               stride);
      if (rc != 0) {
        g_dp_error = 1;
        return;
      }
    }

    AlnMem pm;
    for (size_t p = 0; p < jobs.size(); p++) {
      const auto& j = jobs[p];
      const int len_i = lens[j.i];
      const int len_j = lens[j.ak];
      std::vector<int>& map = ct->pos_maps[(size_t)j.i * K + j.k];
      pm.pr = &base;
      pm.bonus = nullptr;
      pm.flip_threshold = 0.0f;
      pm.flip_trial = 0;
      pm.flip_stride = 1;
      pm.flip_counter = 0;
      pm.flip_mask = 0;
      pm.margin_sum = 0.0f;
      pm.margin_count = 0;
      pm.ensure(j.rows, j.cols);
      pm.init_window();
      if (!batch_paths.empty()) {
        std::copy(batch_paths.begin() + p * stride,
                  batch_paths.begin() + p * stride + j.rows + 2,
                  pm.path.begin());
      } else {
        pm.seq1 = j.swapped ? seqs[j.ak] : seqs[j.i];
        pm.seq2 = j.swapped ? seqs[j.i] : seqs[j.ak];
        pm.prof1 = nullptr;
        pm.prof2 = nullptr;
        invoke_dp(pm);
        if (g_dp_error) return;
      }
      if (j.swapped) {
        mirror_path(pm, len_i, len_j);
        pm.len_a = len_i;
        pm.len_b = len_j;
      }
      path_to_steps_default(pm);
      const int* path = pm.path.data();
      int pos_a = 0, pos_b = 0;
      int cidx = 1;
      while (path[cidx] != 3) {
        if (path[cidx] == 0) {
          if (pos_a < len_i) map[pos_a] = pos_b;
          pos_a++;
          pos_b++;
        } else if (path[cidx] & 1) {
          pos_b++;
        } else if (path[cidx] & 2) {
          if (pos_a < len_i) map[pos_a] = -1;
          pos_a++;
        }
        cidx++;
      }
    }
  }
};

}  // namespace
}  // namespace kt

/* tree level partition: edges of one level touch disjoint nodes */
static std::vector<std::vector<int>> kt_build_levels(const kt::Engine& eng,
                                                     int numseq,
                                                     int n_tasks) {
  std::vector<int> level(2 * numseq - 1, 0);
  std::vector<std::vector<int>> levels;
  for (int t = 0; t < n_tasks; t++) {
    int a = eng.tasks[t][0], b = eng.tasks[t][1], c = eng.tasks[t][2];
    int lv = 1 + std::max(level[a], level[b]);
    level[c] = lv;
    if ((int)levels.size() < lv) levels.resize(lv);
    levels[lv - 1].push_back(t);
  }
  return levels;
}

extern "C" int32_t kt_align_msa(const uint8_t* flat, const int64_t* off,
                                const int32_t* len, int32_t numseq,
                                const int32_t* tasks, int32_t n_tasks,
                                const float* subm, float gpo, float gpe,
                                float tgpe, float dist_scale, float vsm_amax,
                                float use_seq_weights,
                                const float* seq_distances,
                                const float* cons_seq_distances,
                                int32_t consistency_anchors,
                                float consistency_weight, int32_t refine_mode,
                                int32_t adaptive_budget, int32_t* gaps_out,
                                float* conf_out, int32_t n_threads) {
  kt::Engine eng;
  eng.numseq = numseq;
  eng.seqs.resize(numseq);
  eng.lens.resize(numseq);
  const int nprof = 2 * numseq - 1;
  eng.gaps.resize(numseq);
  eng.sip.resize(nprof);
  eng.nsip.assign(nprof, 0);
  eng.plen.assign(nprof, 0);
  eng.profiles.resize(nprof);
  for (int i = 0; i < numseq; i++) {
    eng.seqs[i] = flat + off[i];
    eng.lens[i] = len[i];
    eng.gaps[i].assign(len[i] + 1, 0);
    eng.sip[i] = {i};
    eng.nsip[i] = 1;
  }
  eng.tasks.resize(n_tasks);
  for (int t = 0; t < n_tasks; t++) {
    eng.tasks[t] = {tasks[3 * t], tasks[3 * t + 1], tasks[3 * t + 2]};
  }
  std::sort(eng.tasks.begin(), eng.tasks.end(),
            [](const std::array<int, 3>& x, const std::array<int, 3>& y) {
              return x[2] < y[2];
            });
  eng.confidence.assign(n_tasks, 0.0f);

  eng.base.subm = subm;
  eng.base.gpo = gpo;
  eng.base.gpe = gpe;
  eng.base.tgpe = tgpe;
  eng.base.soff = 0.0f;
  eng.dist_scale = dist_scale;
  eng.vsm_amax = vsm_amax;
  eng.use_seq_weights = use_seq_weights;
  eng.seq_distances = seq_distances;
  eng.adaptive_budget = adaptive_budget;

  kt::g_dp_error = 0;
  if (consistency_anchors > 0) {
    eng.build_consistency(consistency_anchors, consistency_weight,
                          cons_seq_distances ? cons_seq_distances
                                             : seq_distances);
    if (kt::g_dp_error) return -1;
  }

  /* first pass: progressive alignment in tree order (post-order labels
     guarantee children precede parents when sorted by c).  Edges within
     one tree level touch disjoint nodes and run in parallel (the
     reference's OpenMP task recursion, aln_run.c:65-109). */
  if (refine_mode == 3) {
    for (int t = 0; t < n_tasks && !kt::g_dp_error; t++) {
      eng.align_edge_inline(t, 3);
    }
  } else if (kt::g_merge_batch_hook != nullptr) {
    /* level-synchronous batched merges: every edge of a level goes to
       the device in one callback */
    auto levels = kt_build_levels(eng, numseq, n_tasks);
    for (auto& lv_edges : levels) {
      eng.align_level_batched(lv_edges);
      if (kt::g_dp_error) break;
    }
  } else if (n_threads <= 1 || kt::g_dp_hook != nullptr) {
    for (int t = 0; t < n_tasks && !kt::g_dp_error; t++) {
      eng.align_edge(t);
    }
  } else {
    auto levels = kt_build_levels(eng, numseq, n_tasks);
#ifdef _OPENMP
    omp_set_num_threads(n_threads);
#endif
    for (auto& lv_edges : levels) {
#ifdef _OPENMP
#pragma omp parallel
      {
        kt::AlnMem local;
#pragma omp for schedule(dynamic)
        for (int k = 0; k < (int)lv_edges.size(); k++) {
          eng.align_edge_mt(lv_edges[k], local);
        }
      }
#else
      for (int k = 0; k < (int)lv_edges.size(); k++) {
        eng.align_edge(lv_edges[k]);
      }
#endif
    }
  }

  if (kt::g_dp_error) return -1;

  /* second pass: two-pass refinement */
  if (refine_mode == 1 || refine_mode == 2) {
    float threshold = 0.0f;
    if (refine_mode == 2) threshold = eng.confidence_median();
    eng.clean_alignment_state();
    for (int t = 0; t < n_tasks && !kt::g_dp_error; t++) {
      bool do_refine = refine_mode == 1 ||
                       (refine_mode == 2 && eng.confidence[t] <= threshold);
      if (do_refine) {
        eng.refine_edge(t);
      } else {
        eng.replay_edge(t);
      }
    }
  }

  /* emit gap arrays + confidences */
  {
    int64_t pos = 0;
    for (int i = 0; i < numseq; i++) {
      for (int j = 0; j <= len[i]; j++) gaps_out[pos++] = eng.gaps[i][j];
    }
  }
  for (int t = 0; t < n_tasks; t++) conf_out[t] = eng.confidence[t];
  return kt::g_dp_error ? -1 : 0;
}

extern "C" void kt_set_dp_hook(kt_dp_fn fn) {
  kt::g_dp_hook = fn;
  kt::g_dp_error = 0;
}

extern "C" void kt_set_pairwise_hook(kt_pairwise_fn fn) {
  kt::g_pairwise_hook = fn;
  kt::g_dp_error = 0;
}

extern "C" void kt_set_merge_batch_hook(kt_merge_batch_fn fn) {
  kt::g_merge_batch_hook = fn;
  kt::g_dp_error = 0;
}

extern "C" void kt_set_trial_batch_hook(kt_trial_batch_fn fn) {
  kt::g_trial_batch_hook = fn;
  kt::g_dp_error = 0;
}
