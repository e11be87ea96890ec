"""unspanned_s (s, program span): msa.phase_times["unspanned"] per
alignment, the self time of the program's root span (the call of
kalign_tpu_torch.align_msa less the spans below it: input, distances,
tree, consistency, progressive, output). Near zero while the spans name
all of an alignment's host time; in a traced run its gaps are named by
the program's host range layer.align."""

from msabench import readers


def read(run):
    return readers.phase_mean(run, "unspanned")
