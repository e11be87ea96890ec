"""tree_pairs_s (s, program span): msa.phase_times["tree.pairs"] per
alignment, the native guide tree's pair distances (native/src/kt_tree.cpp:
pair_distance_biased, a whole-sequence BPM, for the leaf sets below 50
sequences), timed by the native code's steady clock within the span
"tree" (a summed span, with "tree.splits" and "tree.upgma" beside it)."""

from msabench import readers


def read(run):
    return readers.phase_mean(run, "tree.pairs")
