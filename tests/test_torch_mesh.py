"""The port's multi-GPU pieces (kalign_tpu_torch/parallel/mesh.py,
gpu/gotoh_mesh.py, the engine "gpu-mesh") against kalign_tpu's on the CPU:
kalign_tpu on conftest's 8-device virtual CPU mesh, the port on meshes of
``["cpu"] * n`` (each shard runs the kernels' plain versions).

Tolerances: the distances and the port against itself bitwise; the
column-sharded DP's decisions bitwise in the valid region (rows < la,
columns < lb) with equal end states and paths, scores within rel 1e-5
(kalign_tpu's shard_map forms u as (A + go) - C where the port's row
kernel adds the precomputed go - C, so the two may round apart); bucket
steps equal and scores within rel 1e-5, as kalign_tpu's own mesh tests
hold them."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu.parallel import mesh as JM
from kalign_tpu.tpu import engine as JTE
from kalign_tpu.tpu.traceback import traceback_batch
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.gpu import _cuda, gotoh_row
from kalign_tpu_torch.gpu import traceback as ttb
from kalign_tpu_torch.gpu.engine import GpuEngine
from kalign_tpu_torch.parallel import mesh as TM

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _cpu_mesh(n):
    return TM.make_mesh(devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _eight_devices():
    if jax.device_count() < 8:
        pytest.fail("kalign_tpu's mesh tests run on conftest's 8 virtual "
                    "CPU devices")


def test_make_mesh_factorises_as_kalign_tpu():
    for n in range(1, 9):
        got = _cpu_mesh(n)
        assert got.shape == JM.make_mesh(n_devices=n).devices.shape, n
        assert got.size == n and got.cards == 1 and not got.spans_processes
        assert all(s.stream is None for s in got.shards)
    assert TM.make_mesh(data=2, devices=["cpu"] * 8).shape == (2, 4)


def test_make_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TM.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.make_mesh(devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TE.get_engine("gpu-mesh")


def test_auto_picks_gpu_mesh_on_several_cards(monkeypatch):
    """kalign_tpu/engine.py:189-204: "tpu-mesh" where more than one device
    is visible; here "gpu-mesh" where more than one card is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert TE.resolve_auto_engine() == "gpu-mesh"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TE.resolve_auto_engine() == "gpu-fast"
    assert TE.resolve_auto_engine(device="cpu") == "host"


def test_auto_picks_gpu_mesh_on_a_group_of_one_card_processes(monkeypatch):
    """F7: after jax.distributed, len(jax.devices()) counts every
    process's devices (kalign_tpu/engine.py:189-204); under a process
    group "auto" counts every process's cards, so two processes with one
    card each take "gpu-mesh"."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TE.resolve_auto_engine() == "gpu-fast"
    gathered = []

    def all_gather_object(out, obj):
        gathered.append(obj)
        out[:] = [obj] * len(out)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    assert TE.resolve_auto_engine() == "gpu-mesh"
    assert gathered == [1]
    assert TE.resolve_auto_engine(device="cpu") == "host"
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    assert TE.resolve_auto_engine() == "gpu-fast"


def test_mesh_cards_count_a_card_per_process_and_device(monkeypatch):
    """Mesh.cards, batch_counts and wide launches count a card per
    process and device: two processes' cuda:0 are two cards (each
    process bounds its own launches by WIDE_LAUNCH_BYTES)."""
    from kalign_tpu_torch.gpu import engine as TGE
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)

    def mesh(devs, ranks, rank=0):
        d = np.array([torch.device(x) for x in devs], dtype=object)
        return TM.Mesh(d.reshape(1, -1), np.array([ranks]), rank)
    assert mesh(["cuda:0"] * 4, [0, 0, 0, 0]).cards == 1
    two = mesh(["cuda:0"] * 4, [0, 0, 1, 1])
    assert (two.cards, two.processes, two.local) == (2, 2, [0, 1])
    assert mesh(["cuda:0", "cuda:1"] * 2, [0, 0, 1, 1]).cards == 4
    assert TM.batch_counts(two, 3) == [1, 1, 1, 0]
    uneven = mesh(["cuda:0"] * 4, [0, 0, 0, 1])
    assert TM.batch_counts(uneven, 4) == [1, 1, 0, 2]
    L1p, L2p = 29952, 29952
    per = GpuEngine.WIDE_LAUNCH_BYTES // TGE.problem_bytes(L1p, L2p)
    eng = GpuEngine(mesh=two)
    assert eng.max_launch(L1p, L2p, sharded=True) == 2 * per
    assert eng.max_launch(L1p, L2p) == per


class _FakeTensor:
    def __init__(self, device):
        self.device = torch.device(device)
        self.is_cuda = self.device.type == "cuda"

    def is_contiguous(self):
        return True


def test_launches_query_their_inputs_device(monkeypatch):
    """A launch for tensors on cuda:1 queries cuda:1's stream, and its
    inputs must be on the current device (a wrapper enters it first)."""
    asked = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: asked.append(i) or 1000 + i, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert _cuda.stream(torch.device("cuda:1")) == 1001
    assert _cuda.stream("cuda:0") == 1000 and asked == [1, 0]
    x = _FakeTensor("cuda:1")
    with pytest.raises(ValueError, match="current device is cuda:0"):
        _cuda.require_cuda("k", x, x)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    _cuda.require_cuda("k", x, x)


def test_every_launch_runs_under_its_inputs_device():
    """Every stream query in the package passes a device and runs inside
    a ``with torch.cuda.device(...)`` block, in its own function or in
    the one that calls it (cudaFuncSetAttribute and the launch act on the
    current device)."""
    import ast

    def under_device(node):
        return isinstance(node, ast.With) and any(
            ast.unparse(i.context_expr).startswith("torch.cuda.device(")
            for i in node.items)

    pkg = os.path.dirname(os.path.abspath(_cuda.__file__))
    found = 0
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py") or name == "_cuda.py":
            continue
        tree = ast.parse(open(os.path.join(pkg, name)).read())
        parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        guarded_calls = {ast.unparse(c.func) for w in ast.walk(tree)
                         if under_device(w) for c in ast.walk(w)
                         if isinstance(c, ast.Call)}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and ast.unparse(node.func) == "_cuda.stream"):
                continue
            found += 1
            assert node.args, (name, node.lineno)
            p, inside, func = parents.get(node), False, None
            while p is not None:
                inside = inside or under_device(p)
                if func is None and isinstance(p, ast.FunctionDef):
                    func = p.name
                p = parents.get(p)
            assert inside or func in guarded_calls, (name, node.lineno)
    assert found >= 9


# ---------------------------------------------------------------------------
def _tokens(path):
    from kalign_tpu_torch.core import alphabet as alpha
    m = tio.read_inputs([path])
    m.quiet = True
    m.essential_input_check()
    m.dealign()
    m.sort_len_name()
    codes = TE._encoded(m, alpha.ALPHA_REDUCED_PROTEIN)
    lens = np.array([len(c) for c in codes], np.int32)
    toks = np.zeros((len(codes), lens.max()), np.uint8)
    for i, c in enumerate(codes):
        toks[i, :len(c)] = c
    return toks, lens


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_anchor_distances_equal_kalign_tpu(n):
    toks, lens = _tokens(os.path.join(DATA, "BB30014.tfa"))
    anchors = list(range(0, 44, 5))
    got = TM.sharded_anchor_distances(_cpu_mesh(n), toks, lens, anchors)
    want = JM.sharded_anchor_distances(JM.make_mesh(n_devices=n), toks,
                                       lens, anchors)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    from kalign_tpu_torch.gpu import distances
    one = distances.raw_distances(toks, lens, anchors, "cpu")
    assert np.array_equal(got, one.astype(np.float32)
                          + distances.length_bias(lens, anchors))


def _bucket(seed, B, L, K=5):
    rng = np.random.default_rng(seed)
    lhs = rng.normal(size=(B, L, 23)).astype(np.float32)
    rhs = rng.normal(size=(B, L, 23)).astype(np.float32)
    pc = -np.abs(rng.normal(loc=5.0, size=(B, 3, L + 1))).astype(np.float32)
    pr = -np.abs(rng.normal(loc=5.0, size=(B, 3, L + 1))).astype(np.float32)
    pc[:, 1] *= 0.2
    pr[:, 1] *= 0.2
    la = rng.integers(8, L + 1, size=B).astype(np.int32)
    lb = rng.integers(8, L + 1, size=B).astype(np.int32)
    eps = np.full(B, 1e-3, np.float32)
    apr = rng.integers(-1, 40, (B, K, L)).astype(np.int32)
    apc = rng.integers(-1, 40, (B, K, L)).astype(np.int32)
    cfr = rng.random((B, K, L)).astype(np.float32)
    cfc = rng.random((B, K, L)).astype(np.float32)
    return (lhs, rhs, pc, pr, la, lb, eps), \
        (np.float32(2.0 / K), apr, cfr, apc, cfc)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("with_bonus", [False, True])
def test_sharded_bucket_step_equals_kalign_tpu(n, with_bonus):
    """The batch-sharded bucket step (mesh.py:490-546) with and without a
    compact bonus (kalign_tpu takes it dense), at a shard count that is
    not a power of two and at 8."""
    B, L = 24, 128
    args, bonus = _bucket(23 + n, B, L)
    got_steps, got_scores = TM.sharded_bucket_step(
        _cpu_mesh(n), *args, bonus if with_bonus else None)
    dense = JTE._densify_bonus(bonus, B, L, L) if with_bonus else None
    want_steps, want_scores = JM.sharded_bucket_step(
        JM.make_mesh(n_devices=n), *args, dense)
    assert len(got_steps) == B
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5)
    for a, b in zip(got_steps, want_steps):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_bucket_step_is_the_one_device_bucket():
    """n shards give the one-device row route's steps and scores, bit for
    bit, and batched_gotoh the row kernel's outputs."""
    from kalign_tpu_torch.gpu.engine import row_route
    args, bonus = _bucket(5, 12, 128)
    steps3, scores3 = TM.sharded_bucket_step(_cpu_mesh(3), *args, bonus)
    t = [torch.from_numpy(x) for x in args]
    b = (torch.tensor(bonus[0]),) + tuple(torch.from_numpy(x)
                                          for x in bonus[1:])
    steps, n, score = row_route(*t, b)
    assert np.array_equal(scores3, score.numpy().astype(np.float64))
    for k in range(12):
        assert np.array_equal(steps3[k], steps[k, :n[k]].numpy())
    lhs, rhs, pc, pr, la, lb, _ = args
    match = np.einsum("bik,bjk->bij", lhs, rhs).astype(np.float32)
    dec, sc, st = TM.batched_gotoh(_cpu_mesh(4), match, pc, pr, la, lb)
    d1, s1, st1 = gotoh_row.forward(*(torch.from_numpy(x) for x in (
        match, pc, pr, la, lb)))
    assert np.array_equal(sc, s1.numpy()) and np.array_equal(st, st1.numpy())
    for k in range(12):
        assert np.array_equal(dec[k, :la[k], :lb[k]],
                              d1[k, :la[k], :lb[k]].numpy())


# ---------------------------------------------------------------------------
def _walk(dec, la, lb, st):
    steps, n = ttb.walk_rows(torch.from_numpy(dec[None]),
                             torch.tensor([la], dtype=torch.int32),
                             torch.tensor([lb], dtype=torch.int32),
                             torch.tensor([st], dtype=torch.int32),
                             dec.shape[0] + dec.shape[1] + 2)
    return steps[0, :int(n[0])].tolist()


def _jax_walk(dec, la, lb, st):
    steps, n = traceback_batch(jnp.asarray(dec[None]), jnp.asarray([la]),
                               jnp.asarray([lb]), jnp.asarray([st]),
                               dec.shape[0] + dec.shape[1] + 2)
    return np.asarray(steps)[0, :int(np.asarray(n)[0])].tolist()


def _hold_long(n, match, pc, pr, la, lb, rows):
    dec, score, st = TM.sharded_long_gotoh(_cpu_mesh(n), match, pc, pr, la,
                                           lb, rows=rows)
    jd, js, jst = JM.sharded_long_gotoh(JM.make_mesh(n_devices=n), match,
                                        pc, pr, la, lb)
    assert np.array_equal(dec[:la, :lb], jd[:la, :lb])
    assert score == pytest.approx(js, rel=1e-5) and st == jst
    path = _walk(dec, la, lb, st)
    assert path == _jax_walk(jd, la, lb, jst)
    # the port against itself: the unsplit row kernel's bits
    d1, s1, st1 = gotoh_row.forward(*(torch.from_numpy(np.asarray(x)[None])
                                      for x in (match, pc, pr)),
                                    torch.tensor([la], dtype=torch.int32),
                                    torch.tensor([lb], dtype=torch.int32))
    assert np.array_equal(dec[:la], d1[0, :la].numpy())
    assert score == float(s1[0]) and st == int(st1[0])
    return path


@pytest.mark.parametrize("n", [2, 4, 8])
def test_column_sharded_dp_equals_kalign_tpu(n):
    """Random problems (mesh.py's own test's kind), blocks of 16 rows so
    that the strips cross many blocks, la < L1 and L1 not a multiple of
    the block."""
    rng = np.random.default_rng(33 + n)
    for _ in range(3):
        L1 = int(rng.integers(40, 160))
        W = 128
        la = int(rng.integers(30, L1 + 1))
        lb = int(rng.integers(60, W + 1))
        match = rng.normal(scale=3.0, size=(L1, W)).astype(np.float32)
        pc = -np.abs(rng.normal(loc=5.0, size=(3, W + 1))).astype(np.float32)
        pr = -np.abs(rng.normal(loc=5.0, size=(3, L1 + 1))).astype(
            np.float32)
        pc[1] *= 0.2
        pr[1] *= 0.2
        _hold_long(n, match, pc, pr, la, lb, rows=16)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_column_sharded_dp_leading_gap_run_boundary(n):
    """The optimum's leading column-gap run is exactly one band wide, so
    it crosses band 1's first column at row 1: that cell's diagonal
    predecessor is band 0's row-0 state (test_mesh_engine.py:114-150),
    which block 0's strip carries.  Bands are 128 columns wide at the
    least (gotoh_mesh.band_width)."""
    W = 128 * n
    Wd = W // n
    la, lb = 24, W
    match = np.full((la, W), -10.0, np.float32)
    for i in range(la):
        match[i, Wd + i] = 50.0
    pc = np.zeros((3, W + 1), np.float32)
    pc[0], pc[1], pc[2] = -8.0, -4.0, -0.5
    pr = np.zeros((3, la + 1), np.float32)
    pr[0], pr[1], pr[2] = -8.0, -4.0, -0.5
    path = _hold_long(n, match, pc, pr, la, lb, rows=5)
    assert path[:Wd] == [1] * Wd and path[Wd] == 0


@pytest.mark.parametrize("n", [3, 8])
def test_long_merge_pads_a_width_that_is_not_a_multiple(n):
    """A merge on the column-sharded route as the engine queues it
    (LongQueue: match bands built on each shard, W padded to a multiple
    of n, the path walked band by band) against kalign_tpu's
    _long_seq_mesh on the same match."""
    rng = np.random.default_rng(7)
    L1p, L2p = 128, 128
    lhs = rng.normal(size=(L1p, 23)).astype(np.float32)
    rhs = rng.normal(size=(L2p, 23)).astype(np.float32)
    pc = -np.abs(rng.normal(loc=5.0, size=(3, L2p + 1))).astype(np.float32)
    pr = -np.abs(rng.normal(loc=5.0, size=(3, L1p + 1))).astype(np.float32)
    pc[1] *= 0.2
    pr[1] *= 0.2
    la, lb = 101, 117
    q = TM.LongQueue(_cpu_mesh(n))
    steps, score = q.walk(q.submit(lhs, rhs, pc, pr, la, lb, 0.0, rows=32))
    match = torch.mm(torch.from_numpy(lhs),
                     torch.from_numpy(rhs).T).numpy()[None]
    eng = JTE.TpuEngine(use_pallas=False, mesh=JM.make_mesh(n_devices=n))
    want, wscores = eng._long_seq_mesh(match, pc[None], pr[None],
                                       np.array([la]), np.array([lb]))
    assert steps.tolist() == want[0].tolist()
    assert score == pytest.approx(wscores[0], rel=1e-5)


# ---------------------------------------------------------------------------
def _port_rows(path, engine, k):
    m = tio.read_inputs([path])
    m.quiet = True
    m = TE.align_msa(m, consistency_anchors=k, engine=engine, device="cpu")
    return tio.format_alignment(m, "fasta"), m


def test_gpu_mesh_long_route_equals_tpu_mesh(monkeypatch):
    """test_mesh_engine_long_seq_route's case: every merge of BB12006 on
    the column-sharded route (the port's width rule, and kalign_tpu's
    pick_plan, forced infeasible) on 8 shards."""
    import kalign_tpu.tpu.gotoh_pallas as gp
    path = os.path.join(DATA, "BB12006.tfa")
    monkeypatch.setattr(gp, "pick_plan", lambda B, W, **kw: (8, 1, False))
    jm = jio.read_inputs([path])
    jm.quiet = True
    jm = JE.align_msa(jm, consistency_anchors=0, engine="tpu-mesh")
    monkeypatch.setattr(GpuEngine, "row_feasible",
                        staticmethod(lambda B, L2p: False))
    fasta, m = _port_rows(path, GpuEngine(mesh=_cpu_mesh(8)), 0)
    assert m.aligned_rows() == jm.aligned_rows()
    assert m.engine_stats["engine"] == "gpu-mesh"
    assert m.engine_stats["long_merges"] == 3
    assert m.engine_stats["row_merges"] == 0


@pytest.mark.parametrize("forced", [False, True])
def test_shard_count_gives_the_same_bytes(forced, monkeypatch):
    """1 to 4 shards (1: the resident pass of gpu-fast) give the same
    FASTA in default mode, with the long route forced or not."""
    if forced:
        monkeypatch.setattr(GpuEngine, "row_feasible",
                            staticmethod(lambda B, L2p: False))
    path = os.path.join(DATA, "BB12006.tfa")
    outs = []
    for n in (1, 2, 3, 4):
        fasta, m = _port_rows(path, GpuEngine(mesh=_cpu_mesh(n)), 5)
        outs.append(fasta)
        assert m.engine_stats["shards"] == n
        assert m.engine_stats.get("long_merges", 0) == (
            3 if forced and n > 1 else 0)
    assert len(set(outs)) == 1
    assert outs[0] == _port_rows(path, "gpu-fast", 5)[0]


@pytest.mark.parametrize("forced", [False, True])
def test_refinement_on_a_mesh(forced, monkeypatch):
    """Refinement's candidate tiles (K per merge, no padding) through the
    mesh's routes give gpu-fast's FASTA on BB11001."""
    from kalign_tpu_torch.core import params as P
    path = os.path.join(DATA, "BB11001.tfa")

    def run(engine):
        m = tio.read_inputs([path])
        m.quiet = True
        m = TE.align_msa(m, consistency_anchors=5, refine=P.REFINE_CONFIDENT,
                         engine=engine, device="cpu")
        return tio.format_alignment(m, "fasta"), m.engine_stats
    want, _ = run("gpu-fast")
    if forced:
        monkeypatch.setattr(GpuEngine, "row_feasible",
                            staticmethod(lambda B, L2p: False))
    got, stats = run(GpuEngine(mesh=_cpu_mesh(3)))
    assert got == want
    assert (stats["long_merges"] > 0) == forced
