"""tree_pair_yield (%, program counter): of the pair distances the
native guide tree computed (native/src/kt_tree.cpp, every ordered pair
of a leaf set and its diagonal), the share the UPGMA needed (the
distinct unordered pairs, ns (ns - 1) / 2 a leaf set), pooled over the
window: 100 x engine_stats["tree_pairs_needed"] /
engine_stats["tree_pairs_computed"]. The probe reads them from the
finished Msa when the harness takes its rows."""

from msabench import readers

NEEDED, COMPUTED = "tree_pairs_needed", "tree_pairs_computed"


def record(args, kwargs):
    stats = getattr(args[0], "engine_stats", None) or {}
    if COMPUTED not in stats:
        return None
    return (stats[NEEDED], stats[COMPUTED])


PROBE = ("kalign_tpu_torch.core.msa:Msa.aligned_rows", record)


def read(run):
    recs = [r for r in run.probes.get(readers.name_of(__file__)) or []
            if r is not None]
    computed = sum(c for _, c in recs)
    if not computed:
        return None
    return 100.0 * sum(n for n, _ in recs) / computed
