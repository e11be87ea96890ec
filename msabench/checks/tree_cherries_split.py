"""tree_cherries_split: the share of the guide trees' cherries (nodes
whose two children are sequences) whose two sequences are of different
clades of the family (reference/homology.py::cherry_counts), pooled
over the alignments of the window, as sp_miss pools pairs.  Judges
the guide tree layer: the tree GpuEngine.build_tree hands the
progressive pass (the native tree below 2,048 sequences, gpu/kmeans.py
from there).  Kalign's tree need not hold a clade whole (over
SARS-CoV-2 lineages 0.16 % apart it merges lineages high in the tree,
and over plastomes it may join a genome to a subtree before its sister),
and on some families pairs a third of its leaves across lineages; over
a window it pairs most within clades, a wrong tree almost none.  An
alignment whose tree was not seen counts as one cherry across clades."""

from msabench.reference import homology


def record(call, args, kwargs):
    out = call(*args, **kwargs)
    codes = list(args[1] if len(args) > 1 else kwargs["codes"])
    return out, (codes, [tuple(int(x) for x in t) for t in out[0]])


AROUND = [("kalign_tpu_torch.gpu.engine:GpuEngine.build_tree", record)]


def counts(fam, rows, records, ctx):
    """(cherries across clades, cherries) of the alignment's tree."""
    if not records:
        return 1, 1
    codes, tasks = records[-1]
    index = homology.order(codes, fam[0])
    return homology.cherry_counts(tasks, index,
                                  ctx["config"]["family"]["clades"])


def value(fam, rows, records, ctx):
    bad, total = counts(fam, rows, records, ctx)
    return bad / total if total else 1.0
