"""The column-sharded route with its walk on the bands' cards
(parallel/mesh.py::walk_bands, LongQueue; gpu/traceback.py::walk_band,
csrc/traceback.cu's band form), the consistency maps over the mesh
(GpuEngine.dp_leaf_batch, long_maps), the band plan by what shares a
card (gpu/gotoh_mesh.py::band_config) and the plain reference of the
DP (msabench/reference/kalign_dp.py), on meshes of ``["cpu"] * n``.

Tolerances: steps, maps and FASTA bitwise (the walk over the bands
against the walk over the bands gathered and against the plain walk
that reads the band holding each column; the sharded route against the
one-device route); scores against the plain reference within rel 1e-6
(it adds in its own order)."""

import os

import numpy as np
import pytest
import torch

from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.gpu import engine as TGE
from kalign_tpu_torch.gpu import gotoh_mesh, gotoh_row
from kalign_tpu_torch.gpu import traceback as tb
from kalign_tpu_torch.gpu.engine import GpuEngine, row_route
from kalign_tpu_torch.parallel import mesh as TM
from msabench.reference import kalign_dp

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _cpu_mesh(n):
    return TM.make_mesh(devices=["cpu"] * n)


def _decisions(rng, L1, W, p_diag, p_ext):
    """Random decision bytes [L1, W] int8: A's next state the diagonal
    with probability p_diag, the gap states extending with p_ext."""
    a = np.where(rng.random((L1, W)) < p_diag, 0,
                 rng.integers(1, 3, (L1, W)))
    ga = rng.random((L1, W)) < p_ext
    gb = rng.random((L1, W)) < p_ext
    return (a | (ga << 2) | (gb << 3)).astype(np.int8)


def _bands(dec, n):
    Wd = dec.shape[1] // n
    return [{"dec": torch.from_numpy(np.ascontiguousarray(
        dec[:, d * Wd:(d + 1) * Wd]))} for d in range(n)]


def _gathered_walk(dec, la, lb, st, ms):
    t = lambda x: torch.tensor([x], dtype=torch.int32)
    s, k = tb.walk_rows(torch.from_numpy(dec)[None], t(la), t(lb), t(st), ms)
    return s[0, :int(k[0])].numpy()


def _band_fetch_walk(bands, la, lb, st, ms):
    """traceback.plain whose fetch reads the band holding each column."""
    Wd = bands[0]["dec"].shape[1]

    def fetch(r, c):
        d = int(c[0]) // Wd
        return bands[d]["dec"][r, c - d * Wd].to(torch.int64) & 0xFF
    t = lambda x: torch.tensor([x], dtype=torch.int32)
    s, k = tb.plain(fetch, t(la), t(lb), t(st), ms)
    return s[0, :int(k[0])].numpy()


# (L1, band width, la, lb, p_diag, p_ext): lb past the band edges and
# short of the last band's end (its pad columns), la short of L1, a walk
# that reaches row 0 bands away from column 0
WALKS = [(120, 128, 120, None, 0.9, 0.3),
         (200, 256, 190, -37, 0.6, 0.7),
         (90, 128, 3, -5, 0.9, 0.3),
         (300, 128, 300, -100, 0.3, 0.9)]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_walk_equals_the_gathered_walk(n):
    """walk_bands from random end states on random decisions: the bands'
    steps in path order equal the walk over the gathered matrix and the
    plain walk with a fetch that reads the band holding each column; the
    path crosses every band edge (n - 1 crossings) and ends in band 0."""
    rng = np.random.default_rng(40 + n)
    mesh = _cpu_mesh(n)
    for L1, Wd, la, lb, p_diag, p_ext in WALKS:
        W = n * Wd
        lb = W if lb is None else W + lb
        dec = _decisions(rng, L1, W, p_diag, p_ext)
        st = int(rng.integers(0, 3))
        ms = L1 + W + 2
        got, crossed, _ = TM.walk_bands(mesh, _bands(dec, n), la, lb,
                                        torch.tensor([st]), ms)
        want = _gathered_walk(dec, la, lb, st, ms)
        assert np.array_equal(got, want)
        assert np.array_equal(got, _band_fetch_walk(_bands(dec, n), la, lb,
                                                    st, ms))
        assert crossed == n - 1
        assert int((got != 1).sum()) == la and int((got != 2).sum()) == lb


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_walk_of_a_dp_equals_the_gathered_walk(n):
    """A column-sharded DP's own decisions (gotoh_mesh.forward over n CPU
    shards, W not a multiple of the bands, lb short of the padded width):
    walk_bands from its end state equals the walk over the gathered
    bands."""
    rng = np.random.default_rng(50 + n)
    L1, W, la, lb = 150, 700, 140, 650
    match = (rng.standard_normal((L1, W)) * 3).astype(np.float32)
    pc = (-rng.integers(16, 96, (3, W + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, (3, L1 + 1)) / 32).astype(np.float32)
    mesh = _cpu_mesh(n)
    Wd = gotoh_mesh.band_width(W, n)
    Wp = Wd * n
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt)
    la_t, lb_t = t([la], torch.int32), t([lb], torch.int32)
    prep = gotoh_row.prepare(
        torch.from_numpy(np.pad(pc, ((0, 0), (0, Wp - W)))[None]),
        torch.from_numpy(pr[None]), la_t, lb_t,
        lb_t.float() / la_t.float(), t([1e-3]))
    mp = np.pad(match, ((0, 0), (0, Wp - W)))
    bands, score, st = gotoh_mesh.forward(
        mesh.shards, [torch.from_numpy(np.ascontiguousarray(
            mp[:, d * Wd:(d + 1) * Wd])) for d in range(n)], prep, la, lb,
        rows=32)
    ms = L1 + Wp + 2
    got, crossed, _ = TM.walk_bands(mesh, bands, la, lb, st, ms)
    dec = torch.cat([b["dec"] for b in bands], dim=1).numpy()
    assert np.array_equal(got, _gathered_walk(dec, la, lb, int(st[0]), ms))
    assert crossed == (lb - 1) // Wd


@pytest.mark.parametrize("start, stop", [((60, 300, 0), (None, 256)),
                                         ((0, 300, 1), (0, 256)),
                                         ((40, 256, 2), (None, 256))])
def test_a_band_walk_stops_at_the_band_edge(start, stop):
    """walk_band over the band of columns 257 .. 384 stops where its
    column reaches 256 and hands over the cell and the state it goes on
    from; along row 0 it stops there too; a walk that starts on the edge
    takes no step."""
    rng = np.random.default_rng(9)
    dec = _decisions(rng, 80, 128, 0.8, 0.4)
    ms = 80 + 384 + 2
    steps, n, end = tb.walk_band(torch.from_numpy(dec)[None],
                                 torch.tensor(start, dtype=torch.int32),
                                 256, ms)
    i, j, s = end[0].tolist()
    assert j == stop[1] and (stop[0] is None or i == stop[0])
    got = steps[0, :int(n[0])].numpy()
    assert int((got != 2).sum()) == start[1] - j
    assert int((got != 1).sum()) == start[0] - i
    if start[1] == 256:
        assert int(n[0]) == 0 and [i, j, s] == list(start)


def _family_on(engine, path, k=5):
    m = tio.read_inputs([path])
    m.quiet = True
    m = TE.align_msa(m, consistency_anchors=k, engine=engine, device="cpu")
    return tio.format_alignment(m, "fasta"), m


def _force_long(monkeypatch, maps=True, merges=True):
    if merges:
        monkeypatch.setattr(GpuEngine, "row_feasible",
                            staticmethod(lambda B, L2p: False))
    if maps:
        monkeypatch.setattr(GpuEngine, "map_sharded",
                            lambda self, L1p, L2p: self.sharded)


@pytest.mark.parametrize("n", [2, 4])
def test_column_sharded_maps_equal_the_one_device_maps(monkeypatch, n):
    """The consistency maps of BB12006 (4 sequences of 220-242 residues,
    4 anchors, 12 map DPs) with every map DP on the column-sharded route
    (map_sharded forced) equal the one-device route's, bonus-free at
    MAP_EPS; each map DP counted in long_maps, every walk crossing its
    bands on their cards, no decision byte moved between cards."""
    from kalign_tpu_torch.gpu.consistency import ConsistencyTable
    seen = {}
    orig = ConsistencyTable.build.__func__

    def build(cls, engine, *a, **k):
        table = orig(cls, engine, *a, **k)
        seen[engine.sharded] = table
        return table
    monkeypatch.setattr(ConsistencyTable, "build", classmethod(build))
    path = os.path.join(DATA, "BB12006.tfa")
    want, _ = _family_on(GpuEngine("cpu"), path)
    _force_long(monkeypatch, merges=False)
    got, m = _family_on(GpuEngine(mesh=_cpu_mesh(n)), path)
    assert got == want
    a, b = seen[False], seen[True]
    assert a.anchor_ids == b.anchor_ids
    assert all(np.array_equal(x, y) for x, y in zip(a.pos_maps, b.pos_maps))
    st = m.engine_stats
    assert st["long_maps"] == 12 and st["long_merges"] == 0
    # bands of 128 columns: every map DP's walk crosses one band edge
    assert st["walk_handoffs"] == 12 and st["dec_moved_bytes"] == 0
    assert all(b["route"] == "long" for b in st["batches"] if b["maps"])


def test_a_map_dp_is_judged_on_the_engines_own_card(monkeypatch):
    """map_sharded holds a map DP's problem_bytes against card_bytes of
    the engine's card, where the one-card route would run it
    (launch_bucket), not against the card with most room: with another
    card of the mesh roomier than the engine's, a DP between the two
    goes column-sharded; one the engine's card holds stays; off the card
    or off a mesh, none."""
    import types
    L = 295296
    need = TGE.problem_bytes(L, L)
    free = {"cuda:0": need - 1, "cuda:1": 2 * need, "cuda:2": 2 * need,
            "cuda:3": 2 * need, "cpu": None}
    monkeypatch.setattr(TGE, "card_bytes",
                        lambda dev: free[str(torch.device(dev))])
    eng = types.SimpleNamespace(sharded=True, device=torch.device("cuda:0"))
    assert GpuEngine.map_sharded(eng, L, L)
    free["cuda:0"] = need
    assert not GpuEngine.map_sharded(eng, L, L)
    free["cuda:0"] = need - 1
    eng.sharded = False
    assert not GpuEngine.map_sharded(eng, L, L)
    eng.sharded, eng.device = True, torch.device("cpu")
    assert not GpuEngine.map_sharded(eng, L, L)


class _Cards:
    """card_bytes of the CPU shards' one device: a budget less what the
    queue holds, as the allocator would count it: the buffers it keeps
    (decisions and match rings, one a band and slot) and the rest of the
    bands of each DP queued."""

    def __init__(self, queue, budget, rest):
        self.queue, self.budget, self.rest = queue, budget, rest
        self.most = 0

    def held(self):
        q = self.queue
        return (sum(b.numel() for b in q.buffers.values())
                + len(q.queued) * self.rest)

    def __call__(self, dev):
        self.most = max(self.most, self.held())
        return self.budget - self.held()


@pytest.mark.parametrize("fit", [1, 2, 5])
def test_a_wave_never_needs_more_than_the_guard_allows(monkeypatch, fit):
    """LongQueue.submit walks queued DPs first while a card cannot hold
    one more DP beside what the queue holds (card_bytes stubbed: a budget
    of ``fit`` DPs with fresh buffers, less the queue's buffers and the
    rest of its queued DPs' bands), and queues at most INFLIGHT: what it
    holds never passes the budget; a walked DP's buffers serve the next
    one; every DP's steps are those of its own walk."""
    mesh = _cpu_mesh(4)
    q = TM.LongQueue(mesh, {})
    L1p, W, rows = 128, 512, 32
    Wd = gotoh_mesh.band_width(W, 4)
    bufs, rest = TM.band_parts(L1p, Wd, rows)
    fresh = q._more(0)(0, bufs)
    cards = _Cards(q, fit * 4 * (fresh + rest), 4 * rest)
    monkeypatch.setattr(TGE, "card_bytes", cards)
    rng = np.random.default_rng(fit)
    dps, want = [], []
    for k in range(5):
        lhs = rng.normal(size=(L1p, 23)).astype(np.float32)
        rhs = rng.normal(size=(W, 23)).astype(np.float32)
        pc = -np.abs(rng.normal(5.0, size=(3, W + 1))).astype(np.float32)
        pr = -np.abs(rng.normal(5.0, size=(3, L1p + 1))).astype(np.float32)
        la, lb = 100 + k, 480 - k
        dps.append(q.submit(lhs, rhs, pc, pr, la, lb, 1e-3, rows=rows))
        assert len(q.queued) == min(fit, q.INFLIGHT, k + 1)
        assert cards.held() <= cards.budget
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
        s, n, sc = row_route(t(lhs[None]), t(rhs[None]), t(pc[None]),
                             t(pr[None]), t(np.array([la], np.int32)),
                             t(np.array([lb], np.int32)),
                             t(np.array([1e-3], np.float32)), None)
        want.append((s[0, :int(n[0])].numpy(), float(sc[0])))
    assert cards.most <= cards.budget
    assert len(q.buffers) == 4 * min(fit, q.INFLIGHT)
    for dp, (steps, score) in zip(dps, want):
        got, sc = q.walk(dp)
        assert np.array_equal(got, steps) and sc == score
    assert not q.queued


def test_what_no_card_holds_raises_the_named_memory_error(monkeypatch):
    """A map DP whose bands no card holds, none queued before it: the
    guard raises MemoryError naming the width and the bands, before any
    operand is made."""
    path = os.path.join(DATA, "BB11001.tfa")
    _force_long(monkeypatch, merges=False)
    made = []
    monkeypatch.setattr(TM, "long_operands", lambda *a: made.append(a))
    monkeypatch.setattr(TGE, "card_bytes", lambda dev: 1024)
    with pytest.raises(MemoryError, match=r"x 128 map DP in 4 bands of 128 "
                                          r"columns"):
        _family_on(GpuEngine(mesh=_cpu_mesh(4)), path)
    assert not made


@pytest.mark.parametrize("Wd", [128, 1024, 7168, 32768, 49152, 77824,
                                114688, 114816, 229632])
def test_band_config_keeps_todays_plans_where_shards_share_a_card(Wd):
    """Shards that share a card (the layouts chip_smoke runs on one card,
    CPU shards) take the plan by width alone, as before: one cluster up
    to 114,688 columns, the wave route of at least WAVE_BANDS clusters
    past it."""
    cfg = gotoh_mesh.band_config(Wd)
    assert gotoh_mesh.band_config(Wd, False) == cfg
    if Wd <= gotoh_row.CLUSTER_MAX_WIDTH:
        assert cfg.route == "cluster" and cfg.blocks <= 16
    else:
        assert cfg.route == "wave" and cfg.bands >= gotoh_mesh.WAVE_BANDS
    cuda = [torch.device(f"cuda:{d}") for d in (0, 0, 1)]
    shared = [gotoh_mesh.Shard(d, None) for d in cuda]
    assert not gotoh_mesh.alone(shared)
    assert not gotoh_mesh.alone([gotoh_mesh.Shard(torch.device("cpu"),
                                                  None)] * 2)
    assert gotoh_mesh.alone(shared[1:])


@pytest.mark.parametrize("Wd", [8192, 16384, 24576, 49152, 73856, 114688,
                                229632])
def test_a_band_alone_on_its_card_takes_the_wave_plan(Wd):
    """A band that has its card to itself takes the wave route from
    ALONE_WAVE_MIN columns on: the plan gotoh_row.wave_config gives the
    width over WAVE_BANDS clusters (fewer where its blocks, whole warps
    of at least WAVE_BLOCK_COLS columns, cover the band in fewer: 6 at
    24,576), as past 114,688 columns, its blocks covering whole quanta;
    below it, the cluster plan of the width."""
    cfg = gotoh_mesh.band_config(Wd, True)
    if Wd < gotoh_mesh.ALONE_WAVE_MIN:
        assert cfg == gotoh_mesh.band_config(Wd)
        return
    assert cfg.route == "wave" and cfg.bands <= max(
        gotoh_mesh.WAVE_BANDS, gotoh_mesh.band_config(Wd).bands
        if Wd > gotoh_row.CLUSTER_MAX_WIDTH else 0)
    widest = gotoh_row.WAVE_CLUSTER * gotoh_row.WAVE_MAX_THREADS * 8
    assert cfg == gotoh_row.wave_config(
        Wd, max(gotoh_mesh.WAVE_BANDS, -(-Wd // widest)))
    Wb = gotoh_mesh.band_width(Wd, 1, True)
    assert Wb >= Wd and Wb % gotoh_row.COL_QUANTUM == 0
    assert gotoh_mesh.band_config(Wb, True) == gotoh_mesh.band_config(
        gotoh_mesh.covered(cfg), True)


def test_the_alone_plan_gives_the_one_device_steps(monkeypatch):
    """A merge on the column-sharded route (LongQueue) with every band
    taken as alone on its card
    (gotoh_mesh.alone forced, ALONE_WAVE_MIN at the quantum, so the bands
    are padded to the wave plan's cover): steps and score those of the
    one-device route."""
    monkeypatch.setattr(gotoh_mesh, "alone", lambda shards: True)
    monkeypatch.setattr(gotoh_mesh, "ALONE_WAVE_MIN", 128)
    gotoh_mesh.band_config.cache_clear()
    try:
        lhs, rhs, pc, pr, la, lb, eps, b = _problem(3, bonus=True)
        assert gotoh_mesh.band_width(rhs.shape[0], 3, True) > \
            gotoh_mesh.band_width(rhs.shape[0], 3)
        q = TM.LongQueue(_cpu_mesh(3))
        steps, score = q.walk(q.submit(lhs, rhs, pc, pr, la, lb, eps, b,
                                       rows=64))
    finally:
        gotoh_mesh.band_config.cache_clear()
    want, wscore = _one_device(lhs, rhs, pc, pr, la, lb, eps, b)
    assert np.array_equal(steps, want)
    assert score == wscore


def _problem(seed, L1p=256, L2p=384, la=200, lb=333, K=3, bonus=True):
    """A seeded pair of profiles: one-hot rows, substitution-like columns,
    dyadic penalties, the compact bonus of K anchors."""
    rng = np.random.default_rng(seed)
    lhs = np.zeros((L1p, 23), np.float32)
    lhs[np.arange(la), rng.integers(0, 4, la)] = 1
    rhs = rng.integers(-3, 6, (L2p, 23)).astype(np.float32)
    rhs[lb:] = 0
    pc = (-rng.integers(16, 96, (3, L2p + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, (3, L1p + 1)) / 32).astype(np.float32)
    b = None
    if bonus:
        b = (np.float32(0.4),
             rng.integers(-1, 40, (K, L1p)).astype(np.int32),
             rng.random((K, L1p), dtype=np.float32),
             rng.integers(-1, 40, (K, L2p)).astype(np.int32),
             rng.random((K, L2p), dtype=np.float32))
    return lhs, rhs, pc, pr, la, lb, 1e-3, b


def _one_device(lhs, rhs, pc, pr, la, lb, eps, b):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    bd = None if b is None else (torch.tensor(b[0]),
                                 *(t(x[None]) for x in b[1:]))
    s, n, sc = row_route(t(lhs[None]), t(rhs[None]), t(pc[None]),
                         t(pr[None]), t(np.array([la], np.int32)),
                         t(np.array([lb], np.int32)),
                         t(np.array([eps], np.float32)), bd)
    return s[0, :int(n[0])].numpy(), float(sc[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bonus", [False, True])
def test_sharded_scores_equal_the_plain_reference(seed, bonus):
    """The column-sharded route (LongQueue) over 2, 3 and 4 CPU shards on
    seeded pairs of profiles:
    the score within rel 1e-6 of msabench/reference/kalign_dp.py's, the
    steps those of the port's one-device route (row_route) bit for bit;
    the reference's own path scores its score."""
    lhs, rhs, pc, pr, la, lb, eps, b = _problem(seed, bonus=bonus)
    ref, ref_steps = kalign_dp.dp(lhs, rhs, pc, pr, la, lb, eps, b)
    want, _ = _one_device(lhs, rhs, pc, pr, la, lb, eps, b)
    for n in (2, 3, 4):
        q = TM.LongQueue(_cpu_mesh(n))
        steps, score = q.walk(q.submit(lhs, rhs, pc, pr, la, lb, eps, b,
                                       rows=64))
        assert score == pytest.approx(ref, rel=1e-6)
        assert np.array_equal(steps, want)
    assert kalign_dp.path_score(lhs, rhs, pc, pr, la, lb, eps, ref_steps,
                                b) == pytest.approx(ref, rel=1e-6)


def test_the_mesh_route_is_spanned_and_counted(monkeypatch):
    """BB12006 in default mode with every map DP and merge column-sharded
    over 4 CPU shards (bands of 128 columns): gpu-fast's FASTA; 12 map
    DPs and 3 merges on the route (long_maps + long_merges), the spans mesh.bands and mesh.walk in
    the alignment's phase times, band crossings counted, no decision byte
    moved between cards."""
    path = os.path.join(DATA, "BB12006.tfa")
    want, _ = _family_on("gpu-fast", path)
    _force_long(monkeypatch)
    got, m = _family_on(GpuEngine(mesh=_cpu_mesh(4)), path)
    assert got == want
    st = m.engine_stats
    assert st["long_maps"] + st["long_merges"] == 12 + 3
    assert st["walk_handoffs"] >= 15 and st["dec_moved_bytes"] == 0
    assert m.phase_times["mesh.bands"] > 0
    assert m.phase_times["mesh.walk"] > 0
    names = [s.name for s in m.spans]
    assert names.count("mesh.walk") == 15
