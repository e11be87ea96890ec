"""The families' true homology and the judge of an alignment."""

import numpy as np
import pytest

from msabench import families
from msabench.reference import homology


def true_rows(seqs, ids):
    """The generator's true alignment: a column per origin id, in the
    order of the ids' first appearance along each sequence."""
    order = []
    seen = set()
    for d in ids:
        prev = None
        for x in d:
            if x not in seen:
                seen.add(x)
                pos = order.index(prev) + 1 if prev is not None else 0
                order.insert(pos, x)
            prev = x
    col = {x: k for k, x in enumerate(order)}
    rows = []
    for s, d in zip(seqs, ids):
        r = ["-"] * len(order)
        for c, x in zip(s, d):
            r[col[x]] = c
        rows.append("".join(r))
    return rows


@pytest.fixture
def fam():
    return families.family(5, [7, 0], root_len=120, lo=100, hi=140,
                           clades=2, alphabet="dna", subs=(0.05, 0.03),
                           max_indel=3)


def test_ids_are_unique_in_a_sequence_and_shared_across(fam):
    seqs, ids = fam
    for s, d in zip(seqs, ids):
        assert len(s) == len(d) == len(set(d.tolist()))
    assert len(set(ids[0].tolist()) & set(ids[1].tolist())) > 80


def test_the_true_alignment_misses_nothing(fam):
    seqs, ids = fam
    rows = true_rows(seqs, ids)
    pairs = homology.sample_pairs(len(seqs), 1)
    assert len(pairs) == 10
    assert homology.judge(rows, seqs, ids, 1) == {"rows_wrong": 0,
                                                  "sp_miss": 0.0}


def test_a_shifted_row_misses_and_a_changed_letter_is_wrong(fam):
    seqs, ids = fam
    rows = true_rows(seqs, ids)
    shifted = [r + "-" for r in rows]
    shifted[2] = "-" + rows[2]
    assert homology.judge(shifted, seqs, ids, 1)["sp_miss"] > 0.2
    changed = list(rows)
    k = next(i for i, c in enumerate(rows[0]) if c != "-")
    changed[0] = rows[0][:k] + ("A" if rows[0][k] != "A" else "C") + \
        rows[0][k + 1:]
    assert homology.judge(changed, seqs, ids, 1) == {"rows_wrong": 1,
                                                     "sp_miss": 1.0}
    assert homology.rows_wrong(rows[:-1], seqs) == 1
    assert homology.rows_wrong(rows[:-1] + [rows[-1] + "-"], seqs) == 1


def test_pairs_are_drawn_from_the_seed():
    a = homology.sample_pairs(64, [3, 0, 1])
    assert len(a) == homology.PAIRS
    assert np.array_equal(a, homology.sample_pairs(64, [3, 0, 1]))
    assert not np.array_equal(a, homology.sample_pairs(64, [4, 0, 1]))
    assert (a[:, 0] < a[:, 1]).all()


def test_order_finds_each_encoded_sequence_among_the_inputs(fam):
    seqs, _ = fam
    code = {c: i + 1 for i, c in enumerate("ACGT")}
    perm = [3, 0, 4, 2, 1]
    codes = [np.array([code[c] for c in seqs[j]], np.uint8) for j in perm]
    assert homology.order(codes, seqs) == perm
    with pytest.raises(ValueError):
        homology.order(codes + [np.ones(3, np.uint8)], seqs)


def test_cherry_counts_read_the_tree_against_the_clades():
    # inputs 0..5, clades j % 2: {0, 2, 4} and {1, 3, 5}; the program's
    # sequence i is input index[i]
    index = [0, 2, 4, 1, 3, 5]
    good = [(0, 1, 6), (6, 2, 7), (3, 4, 8), (8, 5, 9), (7, 9, 10)]
    assert homology.cherry_counts(good[::-1], index, 2) == (0, 2)
    bad = [(0, 3, 6), (6, 1, 7), (2, 4, 8), (8, 5, 9), (7, 9, 10)]
    assert homology.cherry_counts(bad, index, 2) == (2, 2)
    half = [(0, 1, 6), (2, 3, 7), (6, 7, 8), (4, 8, 9), (9, 5, 10)]
    assert homology.cherry_counts(half, index, 2) == (1, 2)
    assert homology.cherry_counts([(6, 7, 8)], index, 2) == (0, 0)


def test_map_pairs_counts_the_homologous_pairs_a_map_pairs():
    ids_s = np.array([0, 1, 9, 2, 3])
    ids_a = np.array([0, 1, 2, 3, 8])
    assert homology.map_pairs([0, 1, -1, 2, 3], ids_s, ids_a) == (4, 4)
    assert homology.map_pairs([0, 1, -1, 3, 2], ids_s, ids_a) == (2, 4)
    assert homology.map_pairs([-1] * 5, ids_s, ids_a) == (0, 4)


def test_indels_per_kb_scale_with_length():
    short = dict(lo=900, hi=1100, clades=1, alphabet="dna",
                 subs=(0.0, 0.0), p_del=1.0, indels_per_kb=(0.0, 20.0),
                 indel_lengths=[1])
    s1, _ = families.family(40, [1, 0], root_len=1000, **short)
    s2, _ = families.family(40, [1, 0], root_len=4000,
                            **dict(short, lo=3600, hi=4400))
    lost1 = np.mean([1000 - len(s) for s in s1])
    lost4 = np.mean([4000 - len(s) for s in s2])
    assert 14 < lost1 < 26 and 3.2 < lost4 / lost1 < 4.8
