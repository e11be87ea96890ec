"""The guide tree's leaf-set pair distances in one batch (gpu/distances.py::
leaf_distances, bpm.plain on the CPU) against the native tree's
own loop (native/src/kt_tree.cpp::leaf_distances) and against the
reference's loop over every ordered pair (kalign_tpu's kt_bpm_block):
the matrices off the diagonal, and the trees GpuEngine and the native
code make from them, byte for byte equal to kalign_tpu's host engine."""

import numpy as np
import pytest

from kalign_tpu import engine as JE
from kalign_tpu import native as jnative
from kalign_tpu_torch import native
from kalign_tpu_torch.gpu import distances
from kalign_tpu_torch.gpu.engine import GpuEngine

N_ANCHORS = 5


def _family(groups, lengths, seed):
    """Random DNA codes, one length range per group, and an anchor
    embedding [N, 8] whose groups lie far apart, so that the k-means
    splits (from 50 sequences) part them."""
    rng = np.random.default_rng(seed)
    codes, rows = [], []
    for g, (size, (lo, hi)) in enumerate(zip(groups, lengths)):
        for _ in range(size):
            codes.append(rng.integers(0, 4, size=int(rng.integers(lo, hi + 1)),
                                      dtype=np.uint8))
        rows.append(100.0 * g + rng.random((size, N_ANCHORS),
                                           dtype=np.float32))
    dm = np.zeros((len(codes), 8), np.float32)
    dm[:, :N_ANCHORS] = np.concatenate(rows)
    return codes, dm


# (groups of the embedding, their length ranges, the leaf sets' sizes)
CASES = {
    # every member of one length: the orientation of each pair is the tie's
    "equal-lengths": ((14,), ((90, 90),), [14]),
    # texts and patterns past bpm.MAX_PATTERN, two of equal length
    "past-the-cap": ((6,), ((1000, 1300),), [6]),
    # 100 sequences: two splits, then leaf sets of 49, 1, 48 and 2
    "sets-1-2-49": ((49, 1, 48, 2), ((30, 60), (40, 40), (30, 60), (45, 45)),
                    [1, 2, 48, 49]),
}


@pytest.fixture(params=sorted(CASES))
def case(request):
    groups, lengths, sizes = CASES[request.param]
    codes, dm = _family(groups, lengths, seed=len(request.param))
    if request.param == "past-the-cap":
        codes[3] = codes[2][::-1].copy()
    return codes, dm, sizes


def _reference_matrix(codes, members):
    """The reference's leaf matrix: pair_distance_biased over every
    ordered pair (i, j), written to both cells, the later write winning
    (kalign_tpu's kt_bpm_block: the longer the text, else the second)."""
    ns = len(members)
    dm = np.zeros((ns, ns), np.float32)
    for i in range(ns):
        for j in range(ns):
            a, b = codes[members[i]], codes[members[j]]
            text, pat = (a, b) if len(a) > len(b) else (b, a)
            d = jnative.lib().kt_bpm_block(
                np.ascontiguousarray(text), np.ascontiguousarray(pat),
                len(text), len(pat))
            bias = min(10000.0, float((len(a) + len(b)) // 2)) / 10000.0
            dm[i, j] = dm[j, i] = np.float32(d) + np.float32(bias)
    return dm


def test_leaf_matrices_match_the_reference_loop(case):
    """The leaf sets the splits make, and each set's matrix from the batch
    and from the native loop: equal, the reference's off the diagonal,
    0 on it."""
    codes, dm, sizes = case
    shape, members, _ = native.tree_leaf_sets(dm, N_ANCHORS)
    sets = native.leaf_sets(shape, members)
    assert sorted(len(s) for s in sets) == sizes
    assert sorted(members.tolist()) == list(range(len(codes)))
    flat, computed = distances.leaf_distances(codes, sets, "cpu")
    assert computed == sum(k * (k - 1) // 2 for k in sizes)
    assert flat.size == sum(k * k for k in sizes)
    at = 0
    for s in sets:
        k = len(s)
        batch = flat[at:at + k * k].reshape(k, k)
        at += k * k
        loop = native.leaf_distances(codes, s)
        assert batch.tobytes() == loop.tobytes()
        assert not np.diagonal(batch).any()
        off_diagonal = ~np.eye(k, dtype=bool)
        want = _reference_matrix(codes, s)
        assert batch[off_diagonal].tobytes() == want[off_diagonal].tobytes()


def test_batch_route_builds_the_native_tree(case):
    """GpuEngine's native route (the batch) and the native tree alone
    (its own loop): tasks and seq_dist byte-equal to each other and to
    kalign_tpu's host engine; every distinct pair computed once."""
    codes, dm, sizes = case
    needed = sum(k * (k - 1) // 2 for k in sizes)
    counts = {}
    tasks, sd = native.build_tree(codes, dm, N_ANCHORS, counts=counts)
    assert counts == {"tree_pairs_computed": needed,
                      "tree_pairs_needed": needed}
    eng = GpuEngine("cpu")
    got_tasks, got_sd = eng.build_tree(codes, dm, N_ANCHORS)
    st = eng.stats
    assert st["tree"] == "native"
    assert st["tree_pairs_computed"] == st["tree_pairs_needed"] \
        == st["tree_pairs_batched"] == needed
    want_tasks, want_sd = JE.HostEngine().build_tree(codes, dm, N_ANCHORS)
    for t in (tasks, got_tasks):
        assert t.tobytes() == want_tasks.tobytes()
    for s in (sd, got_sd):
        assert s.tobytes() == want_sd.tobytes()


def test_leaf_pairs_orient_and_place_each_pair():
    """leaf_pairs of the sets [5, 3, 9] and [7]: (a, b) = (set[q], set[p])
    for p < q, the cells (p, q) and (q, p) of the first 3 x 3 matrix;
    PairBatch takes the longer row as the text and b on equal lengths."""
    a, b, cells, size = distances.leaf_pairs(
        [np.array([5, 3, 9], np.int32), np.array([7], np.int32)])
    assert list(zip(a, b)) == [(3, 5), (9, 5), (9, 3)]
    assert cells.tolist() == [[1, 3], [2, 6], [5, 7]]
    assert size == 10
    lens = np.array([0, 0, 0, 4, 0, 4, 0, 0, 0, 6], np.int32)
    pairs = distances.PairBatch(np.zeros((10, 6), np.uint8), lens, a, b,
                                "cpu")
    assert pairs.text_src.tolist() == [5, 9, 9]
    assert pairs.pat_src.tolist() == [3, 5, 3]
    flat, computed = distances.leaf_distances(
        [], [np.array([4], np.int32)], "cpu")
    assert flat.tolist() == [0.0] and computed == 0
