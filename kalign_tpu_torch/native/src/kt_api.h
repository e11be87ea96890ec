/* kalign_tpu_torch native runtime — C ABI.
 *
 * Exact host-side implementation of the Kalign 3 compute core: distance
 * estimation, guide tree, progressive Gotoh alignment with
 * meet-in-the-middle path recovery, consistency and refinement.  It is
 * the "host" engine, the bit-exact oracle of the "gpu" engine, and the
 * orchestrator that the "gpu" engine drives through the DP hooks below
 * (gpu/exact.py runs every Hirschberg sweep on the card).  Float
 * operations follow the reference's sequential f32 semantics (compiled
 * without FMA contraction).
 *
 * Reference provenance is cited per function in the .cpp files.
 */
#ifndef KT_API_H
#define KT_API_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- pairwise bit-parallel edit distances ------------------------------ */

/* Blocked Myers bit-parallel approximate edit distance with adaptive
 * active-block window; pattern capped at 1024 symbols.
 * (reference: bpm_block, lib/src/bpm.c:356-580) */
int32_t kt_bpm_block(const uint8_t* text, const uint8_t* pattern,
                     int32_t n, int32_t m);

/* Scalar banded-min DP oracle, pattern capped at 255 (bpm.c:28-91). */
int32_t kt_edit_oracle(const uint8_t* text, const uint8_t* pattern,
                       int32_t n, int32_t m);

/* Distance of every sequence to each anchor.
 * out has shape [numseq][stride] where stride = 8*ceil(n_anchors/8);
 * entries beyond n_anchors are 0 (sequence_distance.c:82-131). */
void kt_dist_to_anchors(const uint8_t* flat, const int64_t* off,
                        const int32_t* len, int32_t numseq,
                        const int32_t* anchors, int32_t n_anchors,
                        float* out, int32_t n_threads);

/* ---- guide tree -------------------------------------------------------- */

/* Build the guide tree: bisecting k-means over the anchor-distance
 * embedding with exact UPGMA below the 50-sequence threshold.
 * dm: [numseq][stride] anchor distances (stride = 8*ceil(n_anchors/8)),
 *     may be perturbed by the caller for noisy ensemble trees.
 * shape, members (both null, or both kt_tree_leaf_sets' output on the same
 *     dm): the splits already made; null runs them here.
 * leaf_dm (null, or given with shape): each leaf set's ns*ns pair
 *     distances, row-major, the sets one after another in the shape's
 *     order; the UPGMA reads both triangles (kt_leaf_distances' values)
 *     and never the diagonal.  Null computes them here.
 * tasks_out: 3*(numseq-1) ints (a,b,c) in pre-order; caller sorts by c.
 * seq_dist_out: per-sequence normalized mean anchor distance.
 * stats_out (may be null): 5 doubles, the call's seconds in the k-means
 *     rounds, in the UPGMA leaves' pair distances and in their joins, then
 *     the pair distances computed here (ns*(ns-1)/2 a leaf set, 0 with
 *     leaf_dm) and the distinct unordered pairs the UPGMA needed
 *     (ns*(ns-1)/2 a leaf set).
 * Returns number of tasks or -1. (bisectingKmeans.c:177-271) */
int32_t kt_build_tree(const uint8_t* flat, const int64_t* off,
                      const int32_t* len, int32_t numseq,
                      const float* dm, int32_t n_anchors,
                      const int32_t* shape, const int32_t* members,
                      const float* leaf_dm, int32_t* tasks_out,
                      float* seq_dist_out, double* stats_out);

/* kt_build_tree's splits alone (they read only dm): the tree above the leaf
 * sets in pre-order into shape_out (at most 2*numseq-1 ints: -1 a split,
 * else the size of the next leaf set) and the sets' members into
 * members_out (numseq ints, one set after another, each in the order its
 * UPGMA takes them).  stats_out (may be null): kt_build_tree's 5, the
 * splits' seconds first, the rest 0.  Returns the shape's length. */
int32_t kt_tree_leaf_sets(const float* dm, int32_t n_anchors, int32_t numseq,
                          int32_t* shape_out, int32_t* members_out,
                          double* stats_out);

/* The pair distances a leaf set's UPGMA reads, as kt_build_tree computes
 * them: for members p < q, the biased BPM distance of (members[q],
 * members[p]) (the longer the text, on equal lengths members[p]) in cells
 * (p, q) and (q, p) of dm_out [ns][ns]; the diagonal 0. */
void kt_leaf_distances(const uint8_t* flat, const int64_t* off,
                       const int32_t* len, const int32_t* members,
                       int32_t ns, float* dm_out);

/* UPGMA over a full pairwise matrix (modifies dm_copy in place).
 * Used for --realign tree rebuilds (bisectingKmeans.c:1150-1200). */
int32_t kt_build_tree_pairwise(float* dm, int32_t numseq, int32_t* tasks_out,
                               float* seq_dist_out);

/* ---- progressive alignment -------------------------------------------- */

/* Run the full progressive alignment (optionally with anchor consistency
 * and refinement) over encoded sequences.
 *
 *  seqs     : flat encoded residues (full alphabet), per-seq offsets/lens
 *  tasks    : 3*(numseq-1) ints (a,b,c); sorted by c internally
 *  subm     : 23x23 row-major float
 *  refine   : 0 none, 1 all, 2 confident, 3 inline(3 trials)
 *  gaps_out : flattened per-sequence gap arrays, len_i+1 entries each,
 *             in input order; caller pre-zeroes
 *  conf_out : per-task confidence (mean meetup margin or best SP)
 * Returns 0 on success. */
int32_t kt_align_msa(const uint8_t* flat, const int64_t* off,
                     const int32_t* len, int32_t numseq,
                     const int32_t* tasks, int32_t n_tasks,
                     const float* subm, float gpo, float gpe, float tgpe,
                     float dist_scale, float vsm_amax, float use_seq_weights,
                     const float* seq_distances,
                     const float* cons_seq_distances,
                     int32_t consistency_anchors, float consistency_weight,
                     int32_t refine_mode, int32_t adaptive_budget,
                     int32_t* gaps_out, float* conf_out, int32_t n_threads);

/* ---- pluggable DP backend ---------------------------------------------- */

/* Replace the Hirschberg DP of every merge / consistency pairwise
 * alignment with an external backend (the device wavefront sweep of
 * gpu/exact.py) while
 * keeping all orchestration (profiles, scaling, consistency tables,
 * refinement, flip bookkeeping) in this library.  The callback must
 * reproduce run_align's semantics exactly:
 *   mode       : 0 residuesxresidues, 1 profilexresidues, 2 profilexprofile
 *   seq1/seq2  : encoded residues (mode 0: both; mode 1: seq2 only)
 *   prof1/prof2: 64-float-per-column profiles with boundary blocks
 *                ((len+2)*64 floats; mode 1: prof1 only; mode 2: both)
 *   path_out   : len_a+2 ints, raw Hirschberg path (path[i] = matched
 *                column of row i, -1 for gap rows), pre-set to -1
 *   info_out   : [0] meetup margin sum, [1] meetup margin count
 *   margins_out: optional per-meetup margins in recursion (DFS) order,
 *                up to margins_cap entries (adaptive refine budget)
 * Returns 0 on success; nonzero aborts the alignment. */
typedef int32_t (*kt_dp_fn)(int32_t mode, const uint8_t* seq1,
                            const uint8_t* seq2, const float* prof1,
                            const float* prof2, int32_t len_a, int32_t len_b,
                            int32_t sip, const float* subm, float gpo,
                            float gpe, float tgpe, float soff,
                            const float* bonus, int64_t bstride,
                            float flip_threshold, int32_t flip_trial,
                            int32_t flip_stride, int32_t* path_out,
                            float* info_out, float* margins_out,
                            int32_t margins_cap);

/* Install (or clear, with NULL) the DP backend.  While set, kt_align_msa
 * runs single-threaded and routes every full-path alignment through the
 * callback.
 *
 * CONCURRENCY: the hook pointers and the internal error flag are
 * process-wide globals.  Callers MUST serialize the whole
 * install -> kt_align_msa -> uninstall sequence across threads and
 * engine instances (the Python bindings hold a module-level lock,
 * engine.py _HOOK_LOCK); concurrent installs race and can run one
 * aligner with another's backend. */
void kt_set_dp_hook(kt_dp_fn fn);

/* Optional batched residuesxresidues backend for the consistency
 * pre-pass: all NxK anchor pairwise alignments in ONE callback
 * (SURVEY 2.2: "batched pairwise kernel, NxK problems in one
 * launch").  Each pair is pre-oriented rows=shorter; paths_out row p
 * receives pair p's raw path (lens_a[p]+2 ints, pre-set to -1,
 * stride path_stride).  Returns 0 on success. */
typedef int32_t (*kt_pairwise_fn)(int32_t n_pairs,
                                  const uint8_t* const* seqs_a,
                                  const int32_t* lens_a,
                                  const uint8_t* const* seqs_b,
                                  const int32_t* lens_b, const float* subm,
                                  float gpo, float gpe, float tgpe,
                                  int32_t* paths_out, int64_t path_stride);

void kt_set_pairwise_hook(kt_pairwise_fn fn);

/* Optional batched merge backend: one callback aligns ALL merges of a
 * guide-tree level (they are independent — the reference's OpenMP
 * task axis, aln_run.c:65-109).  Operands arrive pre-oriented exactly
 * as dispatch would orient them (mirroring happens in the driver);
 * per-merge effective parameters ride as arrays.  modes: 0 rr, 1 pr,
 * 2 pp.  paths_out row m receives merge m's raw path (lens_a[m]+2
 * ints, pre-set -1).  Used only for the flip-free progressive pass;
 * refinement trials keep the per-merge hook. */
typedef int32_t (*kt_merge_batch_fn)(
    int32_t n, const int32_t* modes, const uint8_t* const* seqs_a,
    const uint8_t* const* seqs_b, const float* const* profs_a,
    const float* const* profs_b, const int32_t* lens_a,
    const int32_t* lens_b, const int32_t* sips,
    const float* const* bonuses, const int64_t* bstrides,
    const float* gpos, const float* gpes, const float* tgpes,
    const float* soffs, const float* subm, int32_t* paths_out,
    int64_t path_stride, float* margin_sums, int32_t* margin_counts);

void kt_set_merge_batch_hook(kt_merge_batch_fn fn);

/* Optional batched refinement-trial backend: trials 1..K-1 of one
 * merge (round-robin flip perturbation, aln_refine.c:88-346) in one
 * callback — trial 0 must already have run (its mean margin is the
 * flip threshold).  paths_out row t receives trial t's raw path
 * (len_a+2 ints, pre-set -1). */
typedef int32_t (*kt_trial_batch_fn)(
    int32_t mode, const uint8_t* seq1, const uint8_t* seq2,
    const float* prof1, const float* prof2, int32_t len_a, int32_t len_b,
    int32_t sip, const float* subm, float gpo, float gpe, float tgpe,
    float soff, const float* bonus, int64_t bstride, int32_t n_trials,
    float flip_threshold, int32_t flip_stride, int32_t* paths_out,
    int64_t path_stride, float* margin_sums, int32_t* margin_counts);

void kt_set_trial_batch_hook(kt_trial_batch_fn fn);

/* ---- single-merge entry points (kt_single.cpp) ------------------------ */

/* One Hirschberg alignment (run_align) on explicit operands, for
 * differential tests of the device DP: mode and operands as kt_dp_fn;
 * flip_mask is the bitmap flip mode (0: off); path_out len_a+2 ints,
 * pre-set to -1; info_out [0] margin sum, [1] margin count, [2] score. */
int32_t kt_run_align_single(
    int32_t mode, const uint8_t* seq1, const uint8_t* seq2,
    const float* prof1, const float* prof2, int32_t len_a, int32_t len_b,
    int32_t sip, const float* subm, float gpo, float gpe, float tgpe,
    float soff, const float* bonus, int64_t bstride, float flip_threshold,
    int32_t flip_trial, int32_t flip_stride, uint32_t flip_mask,
    int32_t* path_out, float* info_out);

/* Leaf profile of one encoded sequence ((len+2)*64 floats). */
void kt_leaf_profile(const float* subm, float gpo, float gpe, float tgpe,
                     const uint8_t* seq, int32_t len, float* out);

/* Scale a profile's gap penalties for nsip member sequences. */
void kt_scale_gaps(float* prof, int32_t len, int32_t nsip);

/* Merge two profiles along a step path (len+2 ints: [0] = len, then the
 * steps, then the terminator). */
int32_t kt_merge_profiles(const float* pa, const float* pb,
                          const float* subm, float gpo, float gpe,
                          float tgpe, const int32_t* steps, int32_t sipa,
                          int32_t sipb, float use_seq_weights, float* out);

/* POAR consensus column assignment (union-find + cycle-safe topo sort,
 * consensus_msa.c:372-554; kt_consensus.cpp).  Candidates are
 * pre-filtered by min_support in (pair, key) order; counting sort by
 * descending support happens inside.  out_colpos[total_residues]
 * receives each residue's column.  Returns the number of columns. */
int32_t kt_consensus_columns(const int32_t* seq_lengths, int32_t numseq,
                             const int64_t* cand_ei, const int64_t* cand_ej,
                             const int32_t* cand_support, int64_t n_cand,
                             int32_t* out_colpos);

/* Pairwise identity distance matrix from a finalized alignment
 * (1 - matches/aligned_cols; aln_apair_dist.c:9-82).
 * rows: numseq gapped rows, each alnlen chars ('-' for gap, residue
 * codes already encoded +1 so 0 can mean gap).  dm_out: numseq*numseq. */
void kt_aln_pairwise_dist(const uint8_t* gapped, int32_t numseq,
                          int32_t alnlen, float* dm_out);

#ifdef __cplusplus
}
#endif
#endif
