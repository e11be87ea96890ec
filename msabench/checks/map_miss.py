"""map_miss: of the homologous residue pairs of a sequence and an
anchor, the share that the program's consistency map does not pair,
over MAPS maps spread evenly over the table
(reference/homology.py::map_pairs).  Judges the consistency maps layer:
the table ConsistencyTable.build makes (gpu/consistency.py, the DPs of
GpuEngine.dp_leaf_batch and the walk).  An alignment that built no
table, or whose table was not seen, reads 1; a traffic mix without
consistency (no ``consistency`` key) reads 0."""

import numpy as np

from msabench.reference import homology

MAPS = 16


def record(call, args, kwargs):
    result = call(*args, **kwargs)
    return result, picked(result, args, kwargs)


def picked(result, args, kwargs):
    codes = list(args[2] if len(args) > 2 else kwargs["codes"])
    if result is None:
        return codes, None, []
    K, n, anchors = result.K, result.numseq, list(result.anchor_ids)
    picks = []
    for t, i in enumerate(np.linspace(0, n - 1, MAPS).round().astype(int)):
        k = t % K
        if int(i) != anchors[k]:
            picks.append((int(i), k,
                          np.array(result.pos_maps[int(i) * K + k])))
    return codes, anchors, picks


AROUND = [("kalign_tpu_torch.gpu.consistency:ConsistencyTable.build",
           record)]


def value(fam, rows, records, ctx):
    if not ctx["traffic"].get("consistency"):
        return 0.0
    if not records or records[-1][1] is None:
        return 1.0
    codes, anchors, picks = records[-1]
    index = homology.order(codes, fam[0])
    ids = fam[1]
    hit = total = 0
    for i, k, pos_map in picks:
        h, t = homology.map_pairs(pos_map, ids[index[i]],
                                  ids[index[anchors[k]]])
        hit, total = hit + h, total + t
    return 1.0 - hit / total if total else 1.0
