/* Gotoh affine-gap DP with meet-in-the-middle path recovery.
 *
 * Exact reimplementation of the reference compute core:
 *   - 3-state (match / gap-in-row / gap-in-col) forward & backward row
 *     sweeps for the three operand kinds:
 *       residues x residues   (lib/src/aln_seqseq.c)
 *       profile  x residues   (lib/src/aln_seqprofile.c)
 *       profile  x profile    (lib/src/aln_profileprofile.c)
 *   - midpoint meet with 6 transition types, distance-from-middle
 *     tiebreak, margin tracking and flip perturbation
 *   - divide-and-conquer controller (lib/src/aln_controller.c)
 *   - raw-path converters: the default one reproduces the reference's
 *     add_gap_info_to_path_n byte-for-byte INCLUDING its dead gap-bit
 *     loop (aln_setup.c:196 tests the sentinel index, so 4/8/16 bits are
 *     never set on this path); the fixed variant mirrors convert_raw_path
 *     (aln_refine.c:590-672) used by refinement.
 *
 * Terminal-gap handling, boundary states per transition, and float
 * operation order follow the reference exactly (compiled without FMA).
 */
#include "kt_gotoh.h"

#include <cfloat>
#include <cmath>
#include <cstring>

namespace kt {

/* The reference's KALIGN_ALN_SERIAL_THRESHOLD=250 only gates its OpenMP
 * task spawning (aln_controller.c:31-33); the recursion itself is
 * identical either way, so no threshold is needed here. */

void AlnMem::ensure(int la, int lb) {
  len_a = la;
  len_b = lb;
  int g = (la > lb ? la : lb) + 2;
  if ((int)fa.size() < g) {
    fa.resize(g);
    fga.resize(g);
    fgb.resize(g);
    ba.resize(g);
    bga.resize(g);
    bgb.resize(g);
  }
  int p = la + lb + 2;
  if ((int)path.size() < p) {
    path.resize(p);
    tmp_path.resize(p);
  }
}

void AlnMem::init_window() {
  starta = 0;
  startb = 0;
  enda = len_a;
  endb = len_b;
  fa[0] = 0.0f;
  fga[0] = -FLT_MAX;
  fgb[0] = -FLT_MAX;
  ba[0] = 0.0f;
  bga[0] = -FLT_MAX;
  bgb[0] = -FLT_MAX;
  int g = (len_a > len_b ? len_a : len_b) + 2;
  for (int i = 0; i < g; i++) path[i] = -1;
}

#define KT_MAX(a, b) ((a) > (b) ? (a) : (b))
#define KT_MAX3(a, b, c) KT_MAX(KT_MAX(a, b), c)

/* ------------------------------------------------------------------ */
/* unified Gotoh sweeps                                                */
/* ------------------------------------------------------------------ */
/* One forward and one backward row sweep cover all three operand
 * kinds.  Every per-cell penalty is an ADDEND supplied by a small
 * policy class (x - gpe and x + (-gpe) are the same IEEE operation, so
 * the scalar float sequence per cell is unchanged from the reference
 * recurrences in aln_seqseq.c / aln_seqprofile.c /
 * aln_profileprofile.c):
 *
 *   row side (operand A, index i):  gb_ext/gb_open/gb_tg feed the
 *     gap-in-column state; dgb feeds the diagonal's gap->match close.
 *   column side (operand B, index j): ga_ext/ga_open/ga_tg feed the
 *     gap-in-row state; dga the diagonal close.
 *   match(acc, j) adds the substitution score for (current row, col j)
 *     onto the running cell value (profilexprofile adds its weighted
 *     terms one by one in descending residue order).
 *
 * Policies return values for the CURRENT sweep direction; the backward
 * sweep reads its neighbors mirrored exactly like the reference's
 * backward loops. */

struct ModeRR {
  const uint8_t* row_seq;      /* sweep-local row residues */
  const uint8_t* col_seq;      /* 1-based via caller-fixed offset */
  const float* subm;
  float neg_gpo, neg_gpe, neg_tgpe, soff;
  const float* sub_row = nullptr;

  void begin_row(int i) { sub_row = subm + 23 * row_seq[i]; }
  float gb_ext(int) const { return neg_gpe; }
  float gb_open(int) const { return neg_gpo; }
  float gb_tg(int) const { return neg_tgpe; }
  float dgb(int) const { return neg_gpo; }
  float ga_ext(int) const { return neg_gpe; }
  float ga_open(int) const { return neg_gpo; }
  float ga_tg(int) const { return neg_tgpe; }
  float dga(int) const { return neg_gpo; }
  float match(float acc, int j) const {
    return acc + (sub_row[col_seq[j]] - soff);
  }
};

/* profile rows x residue columns.  blk(i) is the 64-float profile
 * block of DP row i (leaf_profile layout; block 0 is the boundary). */
struct ModePR {
  const float* prof;           /* operand A profile, global blocks */
  const uint8_t* col_seq;
  float neg_open, neg_ext, neg_text; /* scalars scaled by sip */
  int next_off;                /* 0 fwd (dgb from block i), 2 bwd (block i+2) */
  const float* row_blk = nullptr;
  const float* row_dgb = nullptr;

  const float* blk(int t) const { return prof + ((int64_t)t << 6); }
  void begin_row(int i) {
    row_blk = blk(i + 1);
    row_dgb = blk(i + 1 + next_off) - 37; /* slot 27 of the neighbor */
  }
  float gb_ext(int) const { return row_blk[28]; }
  float gb_open(int) const { return row_blk[27]; }
  float gb_tg(int) const { return row_blk[29]; }
  float dgb(int) const { return *row_dgb; }
  float ga_ext(int) const { return neg_ext; }
  float ga_open(int) const { return neg_open; }
  float ga_tg(int) const { return neg_text; }
  float dga(int) const { return neg_open; }
  float match(float acc, int j) const {
    return acc + row_blk[32 + col_seq[j]];
  }
};

/* profile x profile.  col_off selects the column block convention:
 * the forward sweep reads column penalties from block j, the backward
 * sweep from block j+1 (reference pointer-walk semantics). */
struct ModePP {
  const float* prof_a;
  const float* prof_b;
  int next_off;                /* 0 fwd, 2 bwd (row/col diagonal-close blocks) */
  int col_off;                 /* 0 fwd, +1 bwd */
  const float* row_blk = nullptr;
  const float* row_dgb = nullptr;
  unsigned int freq[24] = {};
  int n_freq = 0;

  const float* ablk(int t) const { return prof_a + ((int64_t)t << 6); }
  const float* bblk(int j) const {
    return prof_b + ((int64_t)(j + col_off) << 6);
  }
  void begin_row(int i) {
    row_blk = ablk(i + 1);
    row_dgb = ablk(i + 1 + next_off) - 37;
    n_freq = 0;
    for (int c = 0; c < 23; c++) {
      if (row_blk[c]) freq[n_freq++] = c;
    }
  }
  float gb_ext(int) const { return row_blk[28]; }
  float gb_open(int) const { return row_blk[27]; }
  float gb_tg(int) const { return row_blk[29]; }
  float dgb(int) const { return *row_dgb; }
  float ga_ext(int j) const { return bblk(j)[28]; }
  float ga_open(int j) const { return bblk(j)[27]; }
  float ga_tg(int j) const { return bblk(j)[29]; }
  float dga(int j) const { return bblk(j + next_off)[-37]; }
  float match(float acc, int j) const {
    const float* sub = bblk(j) + 32;
    for (int c = n_freq - 1; c >= 0; c--) {
      acc += row_blk[freq[c]] * sub[freq[c]];
    }
    return acc;
  }
};

/* Forward row sweep over rows [row_lo, row_hi) x columns
 * [m.startb, m.endb].  States march left to right; the first column
 * holds the window's seeded boundary, the last column and the
 * window's global edges get terminal-gap treatment. */
template <class Mode>
static void sweep_forward(AlnMem& m, Mode& mode, int row_lo, int row_hi) {
  float* a = m.fa.data();
  float* ga = m.fga.data();
  float* gb = m.fgb.data();
  const int col_lo = m.startb, col_hi = m.endb;
  const bool left_edge = col_lo == 0;
  const bool right_edge = col_hi == m.len_b;

  a[col_lo] = a[0];
  ga[col_lo] = ga[0];
  gb[col_lo] = gb[0];
  if (!left_edge) {
    for (int j = col_lo + 1; j < col_hi; j++) {
      a[j] = -FLT_MAX;
      ga[j] = KT_MAX(ga[j - 1] + mode.ga_ext(j), a[j - 1] + mode.ga_open(j));
      gb[j] = -FLT_MAX;
    }
  } else {
    for (int j = col_lo + 1; j < col_hi; j++) {
      a[j] = -FLT_MAX;
      ga[j] = KT_MAX(ga[j - 1], a[j - 1]) + mode.ga_tg(j);
      gb[j] = -FLT_MAX;
    }
  }
  a[col_hi] = -FLT_MAX;
  ga[col_hi] = -FLT_MAX;
  gb[col_hi] = -FLT_MAX;

  for (int i = row_lo; i < row_hi; i++) {
    mode.begin_row(i);
    float diag_a = a[col_lo];
    float diag_ga = ga[col_lo];
    float diag_gb = gb[col_lo];
    a[col_lo] = -FLT_MAX;
    ga[col_lo] = -FLT_MAX;
    float left_a = a[col_lo];
    float left_ga = ga[col_lo];
    if (!left_edge) {
      gb[col_lo] = KT_MAX(diag_gb + mode.gb_ext(i), diag_a + mode.gb_open(i));
    } else {
      gb[col_lo] = KT_MAX(diag_gb, diag_a) + mode.gb_tg(i);
    }
    int j;
    for (j = col_lo + 1; j < col_hi; j++) {
      float cur_a = a[j];
      float best = KT_MAX3(diag_a, diag_ga + mode.dga(j),
                           diag_gb + mode.dgb(i));
      best = mode.match(best, j);
      if (m.bonus) best += m.bonus[(int64_t)i * m.bstride + j];
      a[j] = best;
      diag_ga = ga[j];
      ga[j] = KT_MAX(left_ga + mode.ga_ext(j), left_a + mode.ga_open(j));
      diag_gb = gb[j];
      gb[j] = KT_MAX(diag_gb + mode.gb_ext(i), cur_a + mode.gb_open(i));
      diag_a = cur_a;
      left_a = a[j];
      left_ga = ga[j];
    }
    float cur_a = a[j];
    float best = KT_MAX3(diag_a, diag_ga + mode.dga(j),
                         diag_gb + mode.dgb(i));
    best = mode.match(best, j);
    if (m.bonus) best += m.bonus[(int64_t)i * m.bstride + j];
    a[j] = best;
    ga[j] = -FLT_MAX;
    if (!right_edge) {
      gb[j] = KT_MAX(gb[j] + mode.gb_ext(i), cur_a + mode.gb_open(i));
    } else {
      gb[j] = KT_MAX(gb[j], cur_a) + mode.gb_tg(i);
    }
  }
}

/* Backward row sweep over rows [row_lo, row_hi) descending x the same
 * column window, right to left; the mirror image of sweep_forward. */
template <class Mode>
static void sweep_backward(AlnMem& m, Mode& mode, int row_lo, int row_hi) {
  float* a = m.ba.data();
  float* ga = m.bga.data();
  float* gb = m.bgb.data();
  const int col_lo = m.startb, col_hi = m.endb;
  const bool left_edge = col_lo == 0;
  const bool right_edge = col_hi == m.len_b;

  a[col_hi] = a[0];
  ga[col_hi] = ga[0];
  gb[col_hi] = gb[0];
  if (!right_edge) {
    for (int j = col_hi - 1; j > col_lo; j--) {
      a[j] = -FLT_MAX;
      ga[j] = KT_MAX(ga[j + 1] + mode.ga_ext(j), a[j + 1] + mode.ga_open(j));
      gb[j] = -FLT_MAX;
    }
  } else {
    for (int j = col_hi - 1; j > col_lo; j--) {
      a[j] = -FLT_MAX;
      ga[j] = KT_MAX(ga[j + 1], a[j + 1]) + mode.ga_tg(j);
      gb[j] = -FLT_MAX;
    }
  }
  a[col_lo] = -FLT_MAX;
  ga[col_lo] = -FLT_MAX;
  gb[col_lo] = -FLT_MAX;

  for (int i = row_hi - 1; i >= row_lo; i--) {
    mode.begin_row(i);
    float diag_a = a[col_hi];
    float diag_ga = ga[col_hi];
    float diag_gb = gb[col_hi];
    a[col_hi] = -FLT_MAX;
    ga[col_hi] = -FLT_MAX;
    float right_a = a[col_hi];
    float right_ga = ga[col_hi];
    if (!right_edge) {
      gb[col_hi] = KT_MAX(diag_gb + mode.gb_ext(i), diag_a + mode.gb_open(i));
    } else {
      gb[col_hi] = KT_MAX(diag_gb, diag_a) + mode.gb_tg(i);
    }
    int j;
    for (j = col_hi - 1; j > col_lo; j--) {
      float cur_a = a[j];
      float best = KT_MAX3(diag_a, diag_ga + mode.dga(j),
                           diag_gb + mode.dgb(i));
      best = mode.match(best, j);
      if (m.bonus) best += m.bonus[(int64_t)i * m.bstride + j];
      a[j] = best;
      diag_ga = ga[j];
      ga[j] = KT_MAX(right_ga + mode.ga_ext(j), right_a + mode.ga_open(j));
      diag_gb = gb[j];
      gb[j] = KT_MAX(diag_gb + mode.gb_ext(i), cur_a + mode.gb_open(i));
      diag_a = cur_a;
      right_a = a[j];
      right_ga = ga[j];
    }
    float cur_a = a[j];
    float best = KT_MAX3(diag_a, diag_ga + mode.dga(j),
                         diag_gb + mode.dgb(i));
    best = mode.match(best, j);
    if (m.bonus) best += m.bonus[(int64_t)i * m.bstride + j];
    a[j] = best;
    ga[j] = -FLT_MAX;
    if (!left_edge) {
      gb[j] = KT_MAX(gb[j] + mode.gb_ext(i), cur_a + mode.gb_open(i));
    } else {
      gb[j] = KT_MAX(gb[j], cur_a) + mode.gb_tg(i);
    }
  }
}

/* ------------------------------------------------------------------ */
/* meetup: shared midpoint-combine machinery                           */
/* ------------------------------------------------------------------ */

struct MeetState {
  float max = -FLT_MAX, max2 = -FLT_MAX;
  int c = -1, c2 = -1;
  int tr = -1, tr2 = -1;

  inline void offer(float s, int trans, int i) {
    if (s > max) {
      max2 = max;
      c2 = c;
      tr2 = tr;
      max = s;
      tr = trans;
      c = i;
    } else if (s > max2) {
      max2 = s;
      c2 = i;
      tr2 = trans;
    }
  }
};

/* margin bookkeeping + flip perturbation, shared across all meetups
   (aln_seqseq.c:375-414 et al.) */
static void finish_meet(AlnMem& m, MeetState& st, int* meet, int* trans,
                        float* score) {
  if (st.max2 > -FLT_MAX) {
    float margin = st.max - st.max2;
    if (m.flip_margins && m.margin_count < m.flip_margin_alloc) {
      m.flip_margins[m.margin_count] = margin;
    }
    m.margin_sum += margin;
    m.margin_count++;
  }
  if (m.flip_threshold > 0.0f && st.c2 >= 0 && st.max2 > -FLT_MAX) {
    float margin = st.max - st.max2;
    if (margin < m.flip_threshold) {
      if (m.flip_bit_map) {
        if (m.flip_counter < m.flip_n_uncertain) {
          int bit = m.flip_bit_map[m.flip_counter];
          if (bit >= 0 && ((1u << bit) & m.flip_mask)) {
            st.c = st.c2;
            st.tr = st.tr2;
          }
        }
      } else if (m.flip_mask != 0) {
        if ((1u << (m.flip_counter % m.flip_stride)) & m.flip_mask) {
          st.c = st.c2;
          st.tr = st.tr2;
        }
      } else if (m.flip_trial > 0) {
        if (m.flip_counter % m.flip_stride == m.flip_trial - 1) {
          st.c = st.c2;
          st.tr = st.tr2;
        }
      }
      m.flip_counter++;
    }
  }
  *meet = st.c;
  *trans = st.tr;
  *score = st.max;
}

/* Transition addends for the meetup: t2/t5 may vary per column
 * (profilexprofile reads the column profile), t3/t6/t7 come from the
 * midpoint row's profile block (or scalars). */
struct MeetRR {
  float neg_gpo, neg_gpe, neg_tgpe;
  float t2(int) const { return neg_gpo; }
  float t5(int) const { return neg_gpo; }
  float t3() const { return neg_gpo; }
  float t6(bool tg) const { return tg ? neg_tgpe : neg_gpe; }
  float t7() const { return neg_gpo; }
};

struct MeetP {
  const float* prof_a;
  const float* prof_b;      /* null for profilexresidues */
  float neg_open;           /* gpo * sip (profilexresidues only) */
  int mid;
  const float* ablk(int t) const { return prof_a + ((int64_t)t << 6); }
  const float* bblk(int t) const { return prof_b + ((int64_t)t << 6); }
  float t2(int i) const { return prof_b ? bblk(i + 1)[27] : neg_open; }
  float t5(int i) const { return prof_b ? bblk(i)[27] : neg_open; }
  float t3() const { return ablk(mid + 1)[27]; }
  float t6(bool tg) const {
    return tg ? ablk(mid + 1)[29] : ablk(mid + 1)[28];
  }
  float t7() const { return ablk(mid)[27]; }
};

template <class Meet>
static void meet_combine(AlnMem& m, const Meet& mt, const int oc[5],
                         int* meet, int* trans, float* score) {
  const float* fa = m.fa.data();
  const float* fga = m.fga.data();
  const float* fgb = m.fgb.data();
  const float* ba = m.ba.data();
  const float* bga = m.bga.data();
  const float* bgb = m.bgb.data();
  const float middle = (float)(oc[3] - oc[2]) / 2.0f + (float)oc[2];
  MeetState st;
  for (int i = oc[2]; i < oc[3]; i++) {
    float sub = fabsf(middle - (float)i) / 1000.0f;
    st.offer(fa[i] + ba[i] - sub, 1, i);
    st.offer(fa[i] + bga[i] + mt.t2(i) - sub, 2, i);
    st.offer(fa[i] + bgb[i] + mt.t3() - sub, 3, i);
    st.offer(fga[i] + ba[i] + mt.t5(i) - sub, 5, i);
    st.offer(fgb[i] + bgb[i] + mt.t6(m.startb == 0) - sub, 6, i);
    st.offer(fgb[i] + ba[i] + mt.t7() - sub, 7, i);
  }
  {
    int i = oc[3];
    float sub = fabsf(middle - (float)i) / 1000.0f;
    st.offer(fa[i] + bgb[i] + mt.t3() - sub, 3, i);
    st.offer(fgb[i] + bgb[i] + mt.t6(m.endb == m.len_b) - sub, 6, i);
  }
  finish_meet(m, st, meet, trans, score);
}

/* ------------------------------------------------------------------ */
/* divide-and-conquer controller (aln_controller.c:21-436)             */
/* ------------------------------------------------------------------ */

static void continue_align(AlnMem& m, const float in[6], const int oc[5],
                           int meet, int transition);

void run_align(AlnMem& m) {
  if (m.starta >= m.enda) return;
  if (m.startb >= m.endb) return;

  float in[6] = {m.fa[0], m.fga[0], m.fgb[0], m.ba[0], m.bga[0], m.bgb[0]};
  int mid = ((m.enda - m.starta) / 2) + m.starta;
  int oc[5] = {m.starta, m.enda, m.startb, m.endb, mid};

  m.enda = mid;
  m.starta2 = mid;
  m.enda2 = oc[1];

  int meet, transition;
  float score;
  if (m.seq1) {
    ModeRR fwd{m.seq1, m.seq2 - 1, m.pr->subm,
               -m.pr->gpo, -m.pr->gpe, -m.pr->tgpe, m.pr->soff};
    sweep_forward(m, fwd, m.starta, m.enda);
    ModeRR bwd{m.seq1, m.seq2, m.pr->subm,
               -m.pr->gpo, -m.pr->gpe, -m.pr->tgpe, m.pr->soff};
    sweep_backward(m, bwd, m.starta2, m.enda2);
    MeetRR mt{-m.pr->gpo, -m.pr->gpe, -m.pr->tgpe};
    meet_combine(m, mt, oc, &meet, &transition, &score);
  } else if (m.prof2) {
    ModePP fwd{m.prof1, m.prof2, /*next_off=*/0, /*col_off=*/0};
    sweep_forward(m, fwd, m.starta, m.enda);
    ModePP bwd{m.prof1, m.prof2, /*next_off=*/2, /*col_off=*/1};
    sweep_backward(m, bwd, m.starta2, m.enda2);
    MeetP mt{m.prof1, m.prof2, 0.0f, oc[4]};
    meet_combine(m, mt, oc, &meet, &transition, &score);
  } else {
    const float open = m.pr->gpo * m.sip;
    const float ext = m.pr->gpe * m.sip;
    const float text = m.pr->tgpe * m.sip;
    ModePR fwd{m.prof1, m.seq2 - 1, -open, -ext, -text, /*next_off=*/0};
    sweep_forward(m, fwd, m.starta, m.enda);
    ModePR bwd{m.prof1, m.seq2, -open, -ext, -text, /*next_off=*/2};
    sweep_backward(m, bwd, m.starta2, m.enda2);
    MeetP mt{m.prof1, nullptr, -open, oc[4]};
    meet_combine(m, mt, oc, &meet, &transition, &score);
  }
  if (m.score_only) {
    m.score = score;
  } else {
    continue_align(m, in, oc, meet, transition);
  }
}

static void continue_align(AlnMem& m, const float in[6], const int oc[5],
                           int meet, int transition) {
  int* path = m.path.data();
  switch (transition) {
    case 1: /* match -> match */
      path[oc[4]] = meet;
      path[oc[4] + 1] = meet + 1;
      m.fa[0] = in[0];
      m.fga[0] = in[1];
      m.fgb[0] = in[2];
      m.ba[0] = 0.0f;
      m.bga[0] = -FLT_MAX;
      m.bgb[0] = -FLT_MAX;
      m.starta = oc[0];
      m.enda = oc[4] - 1;
      m.startb = oc[2];
      m.endb = meet - 1;
      run_align(m);
      m.starta = oc[4] + 1;
      m.enda = oc[1];
      m.startb = meet + 1;
      m.endb = oc[3];
      m.fa[0] = 0.0f;
      m.fga[0] = -FLT_MAX;
      m.fgb[0] = -FLT_MAX;
      m.ba[0] = in[3];
      m.bga[0] = in[4];
      m.bgb[0] = in[5];
      run_align(m);
      break;
    case 2: /* match -> gap-in-row */
      path[oc[4]] = meet;
      m.fa[0] = in[0];
      m.fga[0] = in[1];
      m.fgb[0] = in[2];
      m.ba[0] = 0.0f;
      m.bga[0] = -FLT_MAX;
      m.bgb[0] = -FLT_MAX;
      m.starta = oc[0];
      m.enda = oc[4] - 1;
      m.startb = oc[2];
      m.endb = meet - 1;
      run_align(m);
      m.starta = oc[4];
      m.enda = oc[1];
      m.startb = meet + 1;
      m.endb = oc[3];
      m.fa[0] = -FLT_MAX;
      m.fga[0] = 0.0f;
      m.fgb[0] = -FLT_MAX;
      m.ba[0] = in[3];
      m.bga[0] = in[4];
      m.bgb[0] = in[5];
      run_align(m);
      break;
    case 3: /* match -> gap-in-col */
      path[oc[4]] = meet;
      m.fa[0] = in[0];
      m.fga[0] = in[1];
      m.fgb[0] = in[2];
      m.ba[0] = 0.0f;
      m.bga[0] = -FLT_MAX;
      m.bgb[0] = -FLT_MAX;
      m.starta = oc[0];
      m.enda = oc[4] - 1;
      m.startb = oc[2];
      m.endb = meet - 1;
      run_align(m);
      m.starta = oc[4] + 1;
      m.enda = oc[1];
      m.startb = meet;
      m.endb = oc[3];
      m.fa[0] = -FLT_MAX;
      m.fga[0] = -FLT_MAX;
      m.fgb[0] = 0.0f;
      m.ba[0] = in[3];
      m.bga[0] = in[4];
      m.bgb[0] = in[5];
      run_align(m);
      break;
    case 5: /* gap-in-row -> match */
      path[oc[4] + 1] = meet + 1;
      m.fa[0] = in[0];
      m.fga[0] = in[1];
      m.fgb[0] = in[2];
      m.ba[0] = -FLT_MAX;
      m.bga[0] = 0.0f;
      m.bgb[0] = -FLT_MAX;
      m.starta = oc[0];
      m.enda = oc[4];
      m.startb = oc[2];
      m.endb = meet - 1;
      run_align(m);
      m.starta = oc[4] + 1;
      m.enda = oc[1];
      m.startb = meet + 1;
      m.endb = oc[3];
      m.fa[0] = 0.0f;
      m.fga[0] = -FLT_MAX;
      m.fgb[0] = -FLT_MAX;
      m.ba[0] = in[3];
      m.bga[0] = in[4];
      m.bgb[0] = in[5];
      run_align(m);
      break;
    case 6: /* gap-in-col -> gap-in-col */
      m.fa[0] = in[0];
      m.fga[0] = in[1];
      m.fgb[0] = in[2];
      m.ba[0] = -FLT_MAX;
      m.bga[0] = -FLT_MAX;
      m.bgb[0] = 0.0f;
      m.starta = oc[0];
      m.enda = oc[4] - 1;
      m.startb = oc[2];
      m.endb = meet;
      run_align(m);
      m.starta = oc[4] + 1;
      m.enda = oc[1];
      m.startb = meet;
      m.endb = oc[3];
      m.fa[0] = -FLT_MAX;
      m.fga[0] = -FLT_MAX;
      m.fgb[0] = 0.0f;
      m.ba[0] = in[3];
      m.bga[0] = in[4];
      m.bgb[0] = in[5];
      run_align(m);
      break;
    case 7: /* gap-in-col -> match */
      path[oc[4] + 1] = meet + 1;
      m.fa[0] = in[0];
      m.fga[0] = in[1];
      m.fgb[0] = in[2];
      m.ba[0] = -FLT_MAX;
      m.bga[0] = -FLT_MAX;
      m.bgb[0] = 0.0f;
      m.starta = oc[0];
      m.enda = oc[4] - 1;
      m.startb = oc[2];
      m.endb = meet;
      run_align(m);
      m.starta = oc[4] + 1;
      m.enda = oc[1];
      m.startb = meet + 1;
      m.endb = oc[3];
      m.fa[0] = 0.0f;
      m.fga[0] = -FLT_MAX;
      m.fgb[0] = -FLT_MAX;
      m.ba[0] = in[3];
      m.bga[0] = in[4];
      m.bgb[0] = in[5];
      run_align(m);
      break;
    default:
      break;
  }
}

/* ------------------------------------------------------------------ */
/* path post-processing                                                */
/* ------------------------------------------------------------------ */

void mirror_path(AlnMem& m, int len_a, int len_b) {
  int* apath = m.path.data();
  int* opath = m.tmp_path.data();
  for (int i = 0; i < len_a + 2; i++) opath[i] = -1;
  for (int i = 1; i <= len_b; i++) {
    if (apath[i] != -1) opath[apath[i]] = i;
  }
  std::swap(m.path, m.tmp_path);
}

/* Reference add_gap_info_to_path_n (aln_setup.c:121-228): converts the
 * raw column-match path to 0/1/2 steps.  Its gap open/close bit loop
 * tests the sentinel slot and therefore never runs; only terminal-gap
 * flags (bit 32) are applied.  Reproduced as-is for parity. */
void path_to_steps_default(AlnMem& m) {
  const int len_a = m.len_a;
  const int len_b = m.len_b;
  int* path = m.path.data();
  int* o = m.tmp_path.data();
  for (int i = 0; i < len_a + len_b + 2; i++) o[i] = 0;

  int j = 1;
  int b = -1;
  if (path[1] == -1) {
    o[j++] = 2;
  } else {
    if (path[1] != 1) {
      for (int a = 0; a < path[1] - 1; a++) o[j++] = 1;
      o[j++] = 0;
    } else {
      o[j++] = 0;
    }
  }
  b = path[1];
  for (int i = 2; i <= len_a; i++) {
    if (path[i] == -1) {
      o[j++] = 2;
    } else {
      if (path[i] - 1 != b && b != -1) {
        for (int a = 0; a < path[i] - b - 1; a++) o[j++] = 1;
        o[j++] = 0;
      } else {
        o[j++] = 0;
      }
    }
    b = path[i];
  }
  if (path[len_a] < len_b && path[len_a] != -1) {
    for (int a = 0; a < len_b - path[len_a]; a++) o[j++] = 1;
  }
  o[0] = j - 1;
  o[j] = 3;
  /* (dead gap-bit annotation loop omitted: reference condition is never
     true, aln_setup.c:196) */
  int i = 1;
  while (o[i] != 0) {
    o[i] |= 32;
    i++;
  }
  i = o[0];
  while (o[i] != 0) {
    o[i] |= 32;
    i--;
  }
  std::swap(m.path, m.tmp_path);
}

/* Fixed converter used by refinement (convert_raw_path,
 * aln_refine.c:590-672): correct b_last tracking + full gap-bit pass. */
void path_to_steps_fixed(AlnMem& m) {
  const int len_a = m.len_a;
  const int len_b = m.len_b;
  int* path = m.path.data();
  int* o = m.tmp_path.data();
  for (int i = 0; i < len_a + len_b + 2; i++) o[i] = 0;

  int j = 1;
  int b_last = 0;
  for (int i = 1; i <= len_a; i++) {
    if (path[i] == -1) {
      o[j++] = 2;
    } else {
      for (int a = b_last + 1; a < path[i]; a++) o[j++] = 1;
      o[j++] = 0;
      b_last = path[i];
    }
  }
  for (int a = b_last + 1; a <= len_b; a++) o[j++] = 1;

  o[0] = j - 1;
  o[j] = 3;

  int i = 2;
  while (o[i] != 3) {
    if ((o[i - 1] & 3) && !(o[i] & 3)) {
      if (o[i - 1] & 8) {
        o[i - 1] += 8;
      } else {
        o[i - 1] |= 16;
      }
    } else if (!(o[i - 1] & 3) && (o[i] & 3)) {
      o[i] |= 4;
    } else if ((o[i - 1] & 1) && (o[i] & 1)) {
      o[i] |= 8;
    } else if ((o[i - 1] & 2) && (o[i] & 2)) {
      o[i] |= 8;
    }
    i++;
  }
  i = 1;
  while (o[i] != 0) {
    o[i] |= 32;
    i++;
  }
  i = o[0];
  while (o[i] != 0) {
    o[i] |= 32;
    i--;
  }
  std::swap(m.path, m.tmp_path);
}

}  // namespace kt
