"""Judge an alignment and the program's stages against the family's true
homology.

The families of msabench/families.py carry, for every residue, the id of
its origin; two residues are homologous when their ids are equal, and
member i belongs to clade i % clades.  The checks (msabench/checks/)
are built from these:

* ``rows_wrong``: rows that are not their input with gaps put in (a
  letter changed, dropped or added, a row missing or out of order, or a
  row of another width than the first).  Exact: its limit is 0.
* ``sp_miss``: 1 - SP recall over a sample of sequence pairs drawn from
  the seed: of the homologous residue pairs of the sampled pairs, the
  share that the rows do not put in one column.  This is BAliBASE's sum
  of pairs score taken against the generator's true alignment.
* ``cherry_counts``: a guide tree's cherries (two sequences merged
  first), and those whose sequences are of different clades.
* ``map_miss``: of the homologous residue pairs of a sequence and an
  anchor, the share that a consistency map (residue -> anchor position)
  does not pair.

The program works on its sequences in an order of its own; ``order``
finds each of its encoded sequences among the inputs by content.
"""

import numpy as np

GAP = ord("-")
# sequence pairs judged per family (all pairs where a family has fewer)
PAIRS = 256


def columns(row: str) -> np.ndarray:
    """The column of each residue of an aligned row."""
    return np.flatnonzero(np.frombuffer(row.encode(), np.uint8) != GAP)


def ungapped(row: str) -> str:
    return row.replace("-", "")


def rows_wrong(rows, seqs) -> int:
    """Rows that are not their input sequence with gaps put in; a missing
    row counts as wrong, and so does a row whose width differs from the
    first row's."""
    wrong = abs(len(seqs) - len(rows))
    width = len(rows[0]) if rows else 0
    for row, seq in zip(rows, seqs):
        if len(row) != width or ungapped(row).upper() != seq.upper():
            wrong += 1
    return wrong


def sample_pairs(n: int, seed, k: int = PAIRS) -> np.ndarray:
    """[P, 2] pairs i < j: all of them where there are at most k, else k
    drawn without repetition from the seed."""
    iu, ju = np.triu_indices(n, 1)
    if len(iu) <= k:
        return np.stack([iu, ju], 1)
    pick = np.random.default_rng(seed).choice(len(iu), k, replace=False)
    return np.stack([iu[np.sort(pick)], ju[np.sort(pick)]], 1)


def pair_counts(cols_a, ids_a, cols_b, ids_b, width: int):
    """(homologous pairs put in one column, homologous pairs) of two
    aligned sequences: cols_* the column of each residue, ids_* its
    origin."""
    at = np.full(width, -1, np.int64)
    at[cols_b] = ids_b
    hit = int(np.count_nonzero(at[cols_a] == ids_a))
    return hit, int(np.intersect1d(ids_a, ids_b, assume_unique=True).size)


def sp_miss(rows, ids, pairs) -> float:
    """1 - SP recall of the rows over the sampled pairs."""
    width = max(len(r) for r in rows)
    cols = {}
    hit = total = 0
    for i, j in pairs:
        for x in (i, j):
            if x not in cols:
                cols[x] = columns(rows[x])
        h, t = pair_counts(cols[i], ids[i], cols[j], ids[j], width)
        hit += h
        total += t
    return 1.0 - hit / total if total else 0.0


def order(codes, seqs):
    """[input index] of each encoded sequence codes[i]: the input of the
    same length whose letters map to the codes one to one (a sequence's
    encoding is a function of its letter).  Raises where one has none."""
    by_len = {}
    for j, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(j)
    raw = [np.frombuffer(s.upper().encode(), np.uint8) for s in seqs]
    out, used = [], set()
    for c in codes:
        c = np.asarray(c, np.int64)
        for j in by_len.get(len(c), []):
            if j in used:
                continue
            pairs = np.unique(raw[j].astype(np.int64) * 256 + c)
            if len(np.unique(pairs // 256)) == len(pairs) \
                    and len(np.unique(pairs % 256)) == len(pairs):
                out.append(j)
                used.add(j)
                break
        else:
            raise ValueError(f"no input of length {len(c)} matches an "
                             "encoded sequence")
    return out


def cherry_counts(tasks, index, clades: int):
    """(cherries whose two inputs are of different clades, cherries) of
    a tree; a cherry is a task whose two children are sequences.
    tasks: [(a, b, parent)] over nodes, where a node below len(index) is
    the program's sequence of that number and index[i] its input; the
    clade of input j is j % clades."""
    n = len(index)
    ch = [(int(a), int(b)) for a, b, _ in tasks if a < n and b < n]
    return sum(index[a] % clades != index[b] % clades for a, b in ch), \
        len(ch)


def map_pairs(pos_map, ids_s, ids_a):
    """(homologous pairs the map pairs, homologous pairs) of a sequence
    and an anchor: pos_map[p] the anchor position of residue p or -1."""
    pos_map = np.asarray(pos_map, np.int64)
    on = pos_map >= 0
    hit = int(np.count_nonzero(
        ids_a[pos_map[on]] == np.asarray(ids_s)[on]))
    return hit, int(np.intersect1d(ids_s, ids_a).size)


def judge(rows, seqs, ids, seed) -> dict:
    """The numbers one family's rows are judged on.  Rows that are
    wrong make sp_miss 1: a pair of them has no columns to judge."""
    wrong = rows_wrong(rows, seqs)
    miss = 1.0 if wrong else sp_miss(rows, ids,
                                     sample_pairs(len(seqs), seed))
    return {"rows_wrong": wrong, "sp_miss": miss}
