"""gpu-mesh at genome lengths on the CPU (kalign_tpu_torch/gpu/engine.py,
parallel/mesh.py, gpu/gotoh_mesh.py), on make_mesh(devices=["cpu"] * 4)
unless a test says otherwise: past the register row kernel's widths no
launch holds a pad problem, a batch-sharded bucket splits unevenly over
the shards, each band of a column-sharded merge gets its match a block
of rows at a time from its source (parallel/mesh.py::band_source) and
never whole, and the mesh's memory guard raises, naming the width.

Tolerance: FASTA byte-identical to the port's gpu-fast and to kalign_tpu's
tpu-fast (KALIGN_TPU_NO_RESIDENT, KALIGN_TPU_NO_AUTOROUTE); match blocks,
decisions, scores and end states bitwise."""

import numpy as np
import pytest
import torch

from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu.core.msa import Msa as JMsa
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core.msa import Msa as TMsa
from kalign_tpu_torch.gpu import engine as TGE
from kalign_tpu_torch.gpu import gotoh_mesh, gotoh_row, gotoh_wave
from kalign_tpu_torch.gpu import prepare as P
from kalign_tpu_torch.gpu.engine import GpuEngine
from kalign_tpu_torch.parallel import mesh as TM


def _cpu_mesh(n=4):
    return TM.make_mesh(devices=["cpu"] * n)


def _force_wide_routes(monkeypatch):
    """The wave route past 7,168 columns (4 bands of 1 block, blocks of
    100 rows), as tests/test_torch_gotoh_wave_family.py forces it, and
    one problem a wide launch."""
    monkeypatch.setattr(gotoh_row, "CLUSTER_MAX_WIDTH", 7168)
    monkeypatch.setattr(gotoh_row, "WAVE_CLUSTER", 1)
    monkeypatch.setattr(gotoh_row, "WAVE_BANDS", 4)
    monkeypatch.setattr(gotoh_wave, "MIN_ROWS", 100)
    monkeypatch.setattr(gotoh_wave, "BLOCK_BYTES", 0)
    monkeypatch.setattr(GpuEngine, "WIDE_LAUNCH_BYTES", 1)


def _wide(stats):
    return [b for b in stats["batches"]
            if b["route"] in ("row", "long") and b["L2p"] > gotoh_row.BAND_MAX]


def test_long_family_on_the_mesh_is_gpu_fast_and_tpu_fast(monkeypatch):
    """chip_smoke's long family (one ~7,300-residue protein and three
    fragments) in default mode on gpu-mesh, the wide routes forced: FASTA
    byte-identical to the port's gpu-fast and to kalign_tpu's tpu-fast;
    the map DPs past 7,168 columns in launches of one real problem on the
    first shard (the wave route), the wide merges column-sharded, no wide
    launch holding a pad problem (la = lb = 8).  Both engines take the
    one-device anchor distances, computed once: the sharded ones are held
    bitwise equal to them in tests/test_torch_mesh.py, and on the CPU the
    plain BPM walks the long text step by step, once per shard."""
    import chip_smoke
    seqs = chip_smoke.long_family(0)
    monkeypatch.setenv("KALIGN_TPU_NO_RESIDENT", "1")
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    m = JMsa.from_sequences(seqs)
    m.quiet = True
    want = jio.format_alignment(
        JE.align_msa(m, consistency_anchors=5, engine="tpu-fast"), "fasta")
    _force_wide_routes(monkeypatch)
    one_device = GpuEngine.anchor_distances
    cached = {}

    def distances(self, codes, anchors):
        if "dm" not in cached:
            cached["dm"] = one_device(GpuEngine("cpu"), codes, anchors)
        return cached["dm"]
    monkeypatch.setattr(GpuEngine, "anchor_distances", distances)
    calls = []
    orig = TM.LongQueue.submit

    def spy(self, *a, **kw):
        calls.append(a[0].shape[0])
        return orig(self, *a, **kw)
    monkeypatch.setattr(TM.LongQueue, "submit", spy)
    out = {}
    for name, engine in (("gpu-fast", "gpu-fast"),
                         ("gpu-mesh", TE.get_engine("gpu-mesh",
                                                    mesh=_cpu_mesh()))):
        m = TMsa.from_sequences(seqs)
        m.quiet = True
        out[name] = TE.align_msa(m, consistency_anchors=5, device="cpu",
                                 autoroute=False, engine=engine)
    mesh = out["gpu-mesh"]
    fasta = tio.format_alignment(mesh, "fasta")
    assert fasta == tio.format_alignment(out["gpu-fast"], "fasta")
    assert fasta == want
    st = mesh.engine_stats
    assert st["engine"] == "gpu-mesh" and st["shards"] == 4
    assert st["long_merges"] == len(calls) >= 1
    wide = _wide(st)
    assert any(b["maps"] for b in wide) and any(
        b["route"] == "long" for b in wide)
    for b in wide:
        assert not np.any((b["la"] == 8) & (b["lb"] == 8)), b
        if b["maps"]:
            assert len(b["la"]) == 1


def _bucket(seed, B, L1p, L2p, la, lb, K=5):
    """A wide merge bucket's host arrays (one-hot rows, substitution-like
    columns, dyadic penalties, the compact bonus of K anchors)."""
    rng = np.random.default_rng(seed)
    lhs = np.zeros((B, L1p, 23), np.float32)
    lhs[np.arange(B)[:, None], np.arange(L1p)[None],
        rng.integers(0, 4, (B, L1p))] = 1
    rhs = rng.integers(-3, 6, (B, L2p, 23)).astype(np.float32)
    pc = (-rng.integers(16, 96, (B, 3, L2p + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, (B, 3, L1p + 1)) / 32).astype(np.float32)
    la = np.asarray(la, np.int32)
    lb = np.asarray(lb, np.int32)
    for k in range(B):
        lhs[k, la[k]:] = 0
        rhs[k, lb[k]:] = 0
    eps = np.full(B, 1e-3, np.float32)
    bonus = (np.float32(0.4), rng.integers(-1, 40, (B, K, L1p)).astype(
        np.int32), rng.random((B, K, L1p), dtype=np.float32),
        rng.integers(-1, 40, (B, K, L2p)).astype(np.int32),
        rng.random((B, K, L2p), dtype=np.float32))
    return lhs, rhs, pc, pr, la, lb, eps, bonus


@pytest.mark.parametrize("n, budget, counts", [
    (4, None, [[2, 2, 1, 1]]),          # one launch of 6, no pads
    (4, 2, [[1, 1, 0, 0]] * 3),         # 2 a card: three launches
    (3, None, [[2, 2, 2]])])
def test_wide_bucket_on_the_batch_axis(monkeypatch, n, budget, counts):
    """A bucket of 6 merges 7,296 columns wide (more than the shards)
    on gpu-mesh's batch axis: real problems only, split unevenly over
    the shards (batch_counts), as many a card as WIDE_LAUNCH_BYTES
    allows (budget problems' bytes); steps and scores bitwise those of
    one device."""
    L1p, L2p = 64, 7296
    args = _bucket(3, 6, L1p, L2p, [64, 50, 64, 33, 60, 64],
                   [7296, 7200, 7169, 7296, 7250, 7290])
    if budget is not None:
        monkeypatch.setattr(GpuEngine, "WIDE_LAUNCH_BYTES",
                            budget * TGE.problem_bytes(L1p, L2p))
    eng = GpuEngine(mesh=_cpu_mesh(n))
    assert not eng.pads(L2p) and eng.pads(gotoh_row.BAND_MAX)
    steps, scores = eng.collect_bucket(eng.dispatch_bucket(*args))
    ref = GpuEngine("cpu")
    want_steps, want_scores = ref.collect_bucket(ref.dispatch_bucket(*args))
    assert np.array_equal(scores, want_scores)
    assert all(np.array_equal(a, b) for a, b in zip(steps, want_steps))
    batches = eng.stats["batches"]
    assert [b["shards"] for b in batches] == counts
    assert all(len(b["la"]) == sum(b["shards"]) for b in batches)
    assert eng.stats["row_merges"] == 6


def test_batch_counts_by_card():
    """Problems per shard: even over the cards, then over each card's
    shards in shard order; a multiple of the shard count splits evenly."""
    from types import SimpleNamespace

    def mesh(devs):
        return SimpleNamespace(devices=np.array(
            [torch.device(d) for d in devs], dtype=object),
            ranks=np.zeros(len(devs), np.int64))
    one = mesh(["cuda:0"] * 4)
    assert TM.batch_counts(one, 3) == [1, 1, 1, 0]
    assert TM.batch_counts(one, 8) == [2, 2, 2, 2]
    two = mesh(["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    assert TM.batch_counts(two, 3) == [1, 1, 1, 0]
    assert TM.batch_counts(two, 5) == [2, 1, 1, 1]
    assert TM.batch_counts(mesh(["cuda:0", "cuda:1"]), 1) == [1, 0]


def test_max_launch_per_card():
    """Past 7,168 columns max_launch sizes a launch by problem_bytes on
    each card (a mesh's batch axis: that many on every card), at most
    WIDE_MAX_PROBLEMS, and the first shard's map DPs take one card's."""
    eng = GpuEngine(mesh=_cpu_mesh(4))
    L1p, L2p = 29952, 29952
    per = GpuEngine.WIDE_LAUNCH_BYTES // TGE.problem_bytes(L1p, L2p)
    assert per == 3
    assert eng.max_launch(L1p, L2p) == per
    assert eng.max_launch(L1p, L2p, sharded=True) == per * eng.mesh.cards
    assert eng.max_launch(np.int32(156032), np.int32(156032)) == 1
    assert eng.max_launch(256, 9728, sharded=True) == \
        GpuEngine.WIDE_MAX_PROBLEMS


def _whole_bands(n, lhs, rhs, la, lb, eps, bonus):
    """Each band's whole match as parallel/mesh.py::long_operands built
    it before its bands came a block of rows at a time (the plain
    version of band_source): the band's product, then, with a bonus,
    bias and bonus added at col0 (prepare.prepare_match)."""
    L2p = rhs.shape[0]
    Wd = gotoh_mesh.band_width(L2p, n)
    Wp = Wd * n
    rhs_p = TM.pad_rows(np.ascontiguousarray(rhs), Wp)
    t = torch.from_numpy
    bands = []
    for d in range(n):
        c0, c1 = d * Wd, (d + 1) * Wd
        m = torch.bmm(t(lhs[None]), t(rhs_p[None, c0:c1]).transpose(1, 2))
        if bonus is not None:
            per_w, apr, cfr, apc, cfc = bonus
            apc = np.pad(apc, ((0, 0), (0, Wp - L2p)), constant_values=-1)
            cfc = np.pad(cfc, ((0, 0), (0, Wp - L2p)))
            b = (torch.tensor(np.float32(per_w)), t(apr[None]),
                 t(cfr[None]), t(np.ascontiguousarray(apc[None, :, c0:c1])),
                 t(np.ascontiguousarray(cfc[None, :, c0:c1])))
            one = [torch.tensor([x], dtype=dt) for x, dt in (
                (la, torch.int32), (lb, torch.int32), (eps, torch.float32))]
            m = P.prepare_match(m, *one, b, col0=c0)
        bands.append(m[0])
    return bands


def _merge(seed, L1p, L2p, la, lb, bonus=True):
    args = _bucket(seed, 1, L1p, L2p, [la], [lb])
    lhs, rhs, pc, pr = (x[0] for x in args[:4])
    b = (args[7][0],) + tuple(a[0] for a in args[7][1:]) if bonus else None
    return lhs, rhs, pc, pr, la, lb, float(args[6][0]), b


@pytest.mark.parametrize("n, rows", [(4, 64), (3, 100), (2, 512)])
@pytest.mark.parametrize("bonus", [True, False])
def test_band_source_blocks_are_the_whole_band(n, rows, bonus):
    """Each band's source, asked for its rows a block at a time (into a
    buffer of a ring, as gotoh_mesh.forward asks), gives blocks that,
    joined, are bitwise the whole band's match as long_operands built it
    before (the last block short, W not a multiple of the bands)."""
    L1p, L2p = 300, 2000
    lhs, rhs, pc, pr, la, lb, eps, b = _merge(5, L1p, L2p, 290, 1990, bonus)
    mesh = _cpu_mesh(n)
    sources, prep, Wp = TM.long_operands(mesh, lhs, rhs, pc, pr, la, lb, eps,
                                         b)
    whole = _whole_bands(n, lhs, rhs, la, lb, eps, b)
    Wd = Wp // n
    assert len(sources) == n and all(w.shape == (L1p, Wd) for w in whole)
    for d, src in enumerate(sources):
        ring = torch.empty((2, rows, Wd))
        parts = [src(r0, min(r0 + rows, L1p),
                     ring[k % 2][:min(rows, L1p - r0)]).clone()
                 for k, r0 in enumerate(range(0, L1p, rows))]
        got = torch.cat(parts)
        assert torch.equal(got.view(torch.int32), whole[d].view(torch.int32))


@pytest.mark.parametrize("n, rows, la, lb", [
    (4, 64, 300, 2000),          # blocks of 64 rows, the last short
    (3, 100, 251, 1999),         # la < L1p
    (2, 128, 300, 700)])         # lb inside the first band
def test_forward_fed_blocks_is_fed_whole_bands(n, rows, la, lb):
    """gotoh_mesh.forward fed each band's source (a ring of two blocks on
    the shard) gives the decisions, score and end state it gives fed the
    whole bands, bitwise; the same as the unsplit row DP on the whole
    match."""
    L1p, L2p = 300, 2000
    lhs, rhs, pc, pr, la, lb, eps, b = _merge(9, L1p, L2p, la, lb)
    mesh = _cpu_mesh(n)
    sources, prep, Wp = TM.long_operands(mesh, lhs, rhs, pc, pr, la, lb, eps,
                                         b)
    whole = _whole_bands(n, lhs, rhs, la, lb, eps, b)
    got = gotoh_mesh.forward(mesh.shards, sources, prep, la, lb, rows)
    want = gotoh_mesh.forward(mesh.shards, whole, prep, la, lb, rows)
    assert all(band["ring"] is not None for band in got[0])
    assert all(band["ring"] is None for band in want[0])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g["dec"], w["dec"])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    full = torch.cat(whole, dim=1)[None, :, :L2p].contiguous()
    t = lambda x: torch.tensor([x], dtype=torch.int32)
    zero = torch.zeros(1)
    row = gotoh_row.forward_plain(full, torch.from_numpy(pc[None]),
                                  torch.from_numpy(pr[None]), t(la), t(lb),
                                  zero, zero)
    dec = torch.cat([band["dec"] for band in got[0]], dim=1)[:, :L2p]
    assert torch.equal(dec[:la, :lb], row[0][0, :la, :lb])
    assert torch.equal(got[1], row[1]) and torch.equal(got[2], row[2])


def test_mesh_guard_names_the_width(monkeypatch):
    """The column-sharded route's memory guard (check_long_fits, in
    LongQueue.submit) raises MemoryError,
    naming the merge's width and the bands', before any operand is made,
    where card_bytes says the card is too small for the bands (each
    band's decisions stay on its card: nothing is gathered for the
    walk); it passes at the card's size."""
    lhs, rhs, pc, pr, la, lb, eps, b = _merge(2, 300, 2000, 300, 2000)
    mesh = _cpu_mesh(4)
    made = []
    monkeypatch.setattr(TM, "long_operands", lambda *a: made.append(a))
    need = 4 * TM.band_bytes(300, 512, gotoh_mesh.BLOCK_ROWS)
    monkeypatch.setattr(TGE, "card_bytes", lambda dev: need - 1)
    with pytest.raises(MemoryError, match=r"300 x 2000 merge in 4 bands "
                                          r"of 512 columns"):
        TM.LongQueue(mesh).submit(lhs, rhs, pc, pr, la, lb, eps, b)
    assert not made
    monkeypatch.setattr(TGE, "card_bytes", lambda dev: need)
    TM.check_long_fits(mesh, 300, 2000)
