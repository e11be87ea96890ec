/* kalign_tpu_torch native guide-tree library — C ABI.
 *
 * Host-side guide-tree construction of the Kalign 3 pipeline: bisecting
 * 2-means over the anchor-distance embedding, exact UPGMA below 50
 * sequences (whose pairwise distances come from the same blocked Myers
 * kernel as the anchor distances).  Float operations follow the
 * reference's sequential f32 semantics (compiled without FMA
 * contraction).
 */
#ifndef KT_API_H
#define KT_API_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Blocked Myers bit-parallel approximate edit distance with adaptive
 * active-block window; pattern capped at 1024 symbols.
 * (reference: bpm_block, lib/src/bpm.c:356-580) */
int32_t kt_bpm_block(const uint8_t* text, const uint8_t* pattern,
                     int32_t n, int32_t m);

/* Build the guide tree: bisecting k-means over the anchor-distance
 * embedding with exact UPGMA below the 50-sequence threshold.
 * dm: [numseq][stride] anchor distances (stride = 8*ceil(n_anchors/8)).
 * tasks_out: 3*(numseq-1) ints (a,b,c) in pre-order; caller sorts by c.
 * seq_dist_out: per-sequence normalized mean anchor distance.
 * Returns number of tasks. (bisectingKmeans.c:177-271) */
int32_t kt_build_tree(const uint8_t* flat, const int64_t* off,
                      const int32_t* len, int32_t numseq,
                      const float* dm, int32_t n_anchors,
                      int32_t* tasks_out, float* seq_dist_out);

#ifdef __cplusplus
}
#endif
#endif
