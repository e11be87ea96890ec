"""The port's device k-means guide tree (gpu/kmeans.py) on the CPU, where
it runs its plain versions, against kalign_tpu's (tpu/kmeans.py on XLA's
CPU backend): the Lloyd splits, both entry points' trees, the depth cap,
the tree route of GpuEngine, and alignments through the device tree."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import chip_smoke  # noqa: E402
from test_autoroute_kmeans import _dssim_tree_inputs  # noqa: E402

from kalign_tpu import engine as JE  # noqa: E402
from kalign_tpu.core.msa import Msa as JMsa  # noqa: E402
from kalign_tpu.tpu import kmeans as JK  # noqa: E402
from kalign_tpu.tpu.engine import TpuEngine  # noqa: E402
from kalign_tpu_torch import engine as TE  # noqa: E402
from kalign_tpu_torch.core import io as tio  # noqa: E402
from kalign_tpu_torch.core.msa import Msa as TMsa  # noqa: E402
from kalign_tpu_torch.gpu import kmeans as K  # noqa: E402
from kalign_tpu_torch.gpu.engine import GpuEngine  # noqa: E402


def _valid_merge_order(tasks, n):
    tasks = np.asarray(tasks)
    assert tasks.shape == (n - 1, 3)
    assert sorted(int(c) for _, _, c in tasks) == list(range(n, 2 * n - 1))
    seen, used = set(range(n)), set()
    for a, b, c in sorted(tasks, key=lambda t: t[2]):
        assert int(a) in seen and int(b) in seen
        assert int(a) not in used and int(b) not in used
        used.update((int(a), int(b)))
        seen.add(int(c))
    assert len(used) == 2 * n - 2


def _depth0_inputs(n, emb):
    T, S = K.MAX_TRIES, 2048
    idx = np.zeros((1, S), np.int32)
    idx[0, :n] = np.arange(n)
    valid = np.zeros((1, S), bool)
    valid[0, :n] = True
    parity = np.zeros((1, S), np.int32)
    parity[0, :n] = np.arange(n) & 1
    seeds = np.zeros((1, T), np.int32)
    seeds[0] = np.arange(T) * (n // T)
    return idx, valid, parity, seeds, np.array([T], np.int32)


def test_lloyd_batch_matches_kalign_tpu_on_the_root_split():
    """The plain lloyd_batch against _lloyd_batch on the 1,024-sequence
    root split of test_autoroute_kmeans.py::test_fused_depth0_agreement:
    identical assignments (that test allows > 0.99 between the reference's
    own two entry points); and the plain fused_splits' first depth
    against _fused_splits' likewise."""
    codes, dm, na = _dssim_tree_inputs(1024, 100, seed=11)
    emb = np.ascontiguousarray(dm[:, :na].astype(np.float32))
    n = len(codes)
    arrs = _depth0_inputs(n, emb)
    want, want_deg = JK._lloyd_batch(jnp.asarray(emb),
                                     *(jnp.asarray(a) for a in arrs),
                                     T=K.MAX_TRIES)
    got, got_deg, sse = K.lloyd_batch(torch.from_numpy(emb),
                                      *(torch.from_numpy(a) for a in arrs),
                                      K.MAX_TRIES)
    want = np.asarray(want)[0, :n]
    got = got.numpy()[0, :n]
    assert np.mean(got == want) > 0.99
    assert np.array_equal(got, want)
    assert bool(got_deg[0]) == bool(np.asarray(want_deg)[0])
    assert float(sse[0]) > 0

    Np = K._pow2_at_least(n)
    embp = np.zeros((Np, na), np.float32)
    embp[:n] = emb
    Ca = Np // K.UPGMA_THRESHOLD + 1
    cid_j, _ = JK._fused_splits(jnp.asarray(embp), jnp.int32(n), Np=Np,
                                T=K.MAX_TRIES, Dmax=1, Ca=Ca)
    cid_t, left = K.fused_splits(torch.from_numpy(embp), n, Np, K.MAX_TRIES,
                                 1, Ca)
    assert left
    assert np.array_equal(cid_t.numpy()[:n], np.asarray(cid_j)[:n])
    # the fused form against the per-depth form, as the reference holds
    # its own two entry points
    assert np.mean((cid_t.numpy()[:n] & 1) == got) > 0.99


@pytest.mark.parametrize("entry", ["per_depth", "fused"])
def test_device_tree_matches_kalign_tpu(entry):
    """Both entry points on the 600 x 120 seed-7 case of
    test_autoroute_kmeans.py::test_fused_tree_matches_bucketed_small:
    kalign_tpu's tasks and seq_dist exactly, and a valid merge order."""
    codes, dm, na = _dssim_tree_inputs(600, 120, seed=7)
    eng = TpuEngine(1)
    if entry == "per_depth":
        want = JK.build_tree_device(eng, codes, dm, na)
        got = K.build_tree_device(codes, dm, na, "cpu")
    else:
        want = JK.build_tree_device_fused(eng, codes, dm, na)
        got = K.build_tree_device_fused(codes, dm, na, "cpu")
    assert got is not None
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32),
                          np.asarray(want[1]).view(np.int32))
    _valid_merge_order(got[0], len(codes))


def test_traces_compare_equal_runs():
    """A split record per cluster split; two runs of one entry point make
    the same splits, and the fused entry makes the per-depth entry's on
    this case."""
    codes, dm, na = _dssim_tree_inputs(300, 80, seed=3)
    a, b, f = [], [], []
    K.build_tree_device(codes, dm, na, "cpu", trace=a)
    K.build_tree_device(codes, dm, na, "cpu", trace=b)
    K.build_tree_device_fused(codes, dm, na, "cpu", trace=f)
    assert a and compare_ok(a, b) and compare_ok(f, a)
    # a split made otherwise is counted, with its SSE beside the other's
    depth, m, r, s = a[0]
    other = [(depth, m, r[1:], s)] + a[1:]
    differ, first = K.compare_traces(other, a)
    assert differ == 1 and first == (depth, len(m), s, s)


def compare_ok(got, want):
    return K.compare_traces(got, want) == (0, None)


def test_depth_cap_returns_none_and_the_route_falls_back(monkeypatch):
    """A fused run that reaches its depth cap returns None, and
    GpuEngine.build_tree then runs the per-depth entry (a valid tree,
    that entry's tree)."""
    codes, dm, na = _dssim_tree_inputs(300, 80, seed=3)
    assert K.build_tree_device_fused(codes, dm, na, "cpu",
                                     depth_cap=1) is None
    monkeypatch.setattr(K, "_FUSED_DEPTH_CAP", 0)
    assert K.build_tree_device_fused(codes, dm, na, "cpu") is None
    eng = GpuEngine("cpu", device_tree=True)
    tasks, sd = eng.build_tree(codes, dm, na)
    assert eng.stats["tree"] == "device"
    _valid_merge_order(tasks, len(codes))
    want = K.build_tree_device(codes, dm, na, "cpu")
    assert np.array_equal(tasks, want[0])
    assert np.array_equal(sd, want[1])


def test_tree_route_rule():
    """kalign_tpu/tpu/engine.py:321-352 as GpuEngine.tree_route: the device
    tree on the card from 2,048 sequences (the fused entry up to 32,768,
    the per-depth one above), the native tree below and on the CPU; the
    constructor forces either way and sets the fused limit."""
    cuda, cpu = GpuEngine("cuda"), GpuEngine("cpu")
    assert GpuEngine.DEVICE_TREE_MIN_SEQS == 2048
    assert cuda.tree_route(2047) == "native"
    assert cuda.tree_route(2048) == "device_fused"
    assert cuda.tree_route(32768) == "device_fused"
    assert cuda.tree_route(32769) == "device"
    assert cpu.tree_route(100_000) == "native"
    assert GpuEngine("cpu", device_tree=True).tree_route(10) == "device_fused"
    assert GpuEngine("cuda", device_tree=False).tree_route(50_000) == "native"
    assert GpuEngine("cuda", fused_tree_max=0).tree_route(4096) == "device"
    assert GpuEngine("cuda", fused_tree_max=4096).tree_route(4097) == \
        "device"


def test_native_tree_below_the_threshold_on_the_card_route():
    """Forced native on the CPU: the engine records which tree ran."""
    codes, dm, na = _dssim_tree_inputs(120, 60, seed=5)
    eng = GpuEngine("cpu")
    eng.build_tree(codes, dm, na)
    assert eng.stats["tree"] == "native"
    eng = GpuEngine("cpu", device_tree=True)
    eng.build_tree(codes, dm, na)
    assert eng.stats["tree"] == "device_fused"


def _family200():
    return chip_smoke.family(200, seed=6, root_len=100, lo=90, hi=110)


@pytest.mark.parametrize("consistency", [0, 5], ids=["fast", "default"])
def test_alignment_through_the_device_tree_matches_kalign_tpu(consistency,
                                                              monkeypatch):
    """A 200-sequence protein family through the device tree (forced on
    the CPU) in --fast and default mode: kalign_tpu's FASTA (tpu-fast with
    KALIGN_TPU_DEVICE_TREE=1 and KALIGN_TPU_NO_AUTOROUTE=1), or a near-tie
    whose first differing merge scores equal to rel 1e-5 (the tolerance
    of test_torch_engine.py)."""
    seqs = _family200()
    monkeypatch.setenv("KALIGN_TPU_DEVICE_TREE", "1")
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    m = JMsa.from_sequences(seqs)
    m.quiet = True
    ref = JE.align_msa(m, consistency_anchors=consistency, engine="tpu-fast")
    m = TMsa.from_sequences(seqs)
    m.quiet = True
    eng = GpuEngine("cpu", device_tree=True)
    out = TE.align_msa(m, consistency_anchors=consistency, engine=eng,
                       autoroute=False)
    assert out.engine_stats["tree"] == "device_fused"
    got = tio.format_alignment(out, "fasta")
    from kalign_tpu.core import io as jio
    if got != jio.format_alignment(ref, "fasta"):
        a = np.asarray(out.task_confidence, np.float64)
        b = np.asarray(ref.task_confidence, np.float64)
        k = int(np.flatnonzero(a != b)[0])
        assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a[k], b[k])
    chip_smoke.check_alignment(out.aligned_rows(), seqs)


@pytest.mark.parametrize("n,blocks", [
    (1, 1), (50, 1), (51, 1), (1024, 1), (1025, 2), (2048, 2), (4000, 4),
    (8192, 8), (8193, 16), (16384, 16), (100000, 16)])
def test_cluster_blocks_by_member_count(n, blocks):
    """The Lloyd kernel's blocks per thread-block cluster: a power of two
    with ROWS_PER_BLOCK members a block, at most 16; at the root of
    16,384 sequences 16 (40 tries x 16 = 640 blocks)."""
    from kalign_tpu_torch.gpu import kmeans as K
    assert K.cluster_blocks(n) == blocks
    assert K.ROWS_PER_BLOCK == 1024 and K.MAX_CLUSTER_BLOCKS == 16
