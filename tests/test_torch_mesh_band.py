"""The band kernel's plan and padding (kalign_tpu_torch/gpu/gotoh_mesh.py)
on the CPU: which route a band's width takes, the padded band widths,
which shards of a card run their band launches on one stream
(card_streams, the card's occupancy stubbed), and the column-sharded
pipeline's plain version at those widths against the unsplit row DP
(gotoh_row.plain) and against kalign_tpu's sharded_long_gotoh on
conftest's 8-device CPU mesh.

Tolerances: the port against itself bitwise (decisions in the valid
region, rows < la and columns < lb; score; end state); against kalign_tpu
as tests/test_torch_mesh.py holds it: decisions bitwise in the valid
region, equal end states and paths, scores within rel 1e-5 (kalign_tpu
forms u as (A + go) - C where the port adds the precomputed go - C)."""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kalign_tpu.parallel import mesh as JM
from kalign_tpu.tpu.traceback import traceback_batch
from kalign_tpu_torch.gpu import gotoh_mesh, gotoh_row
from kalign_tpu_torch.gpu import traceback as ttb
from kalign_tpu_torch.parallel import mesh as TM


@pytest.mark.parametrize("Wd, route, ch, threads, blocks", [
    (128, "cluster", 4, 32, 1),
    (256, "cluster", 4, 64, 1),
    (512, "cluster", 4, 64, 2),
    (2560, "cluster", 4, 64, 10),    # the mesh_long root merge's bands
    (4096, "cluster", 4, 64, 16),
    (4224, "cluster", 4, 96, 11),
    (8192, "cluster", 4, 128, 16),
    (16384, "cluster", 4, 256, 16),
    (20480, "cluster", 8, 160, 16),
    (114688, "cluster", 8, 896, 16),
    (114816, "wave", 8, 288, 8),      # 2 x 229,632: 7 clusters of 8
    (131072, "wave", 8, 320, 8),
    (229376, "wave", 8, 512, 8),      # the widest blocks
])
def test_band_config_picks_the_route_by_width(Wd, route, ch, threads,
                                               blocks):
    """A cluster of one block of 4 columns a thread up to BLOCK_COLS; past
    it a cluster of at most 16 blocks of at least BLOCK_COLS columns (8 a
    thread past 1,024 a block) up to CLUSTER_MAX_WIDTH; the wave route
    past it: WAVE_BANDS clusters of 8 blocks of at least 256 columns.  A
    cluster's blocks cover the band exactly and fit the card's shared
    memory (the strip ring included); a wave's cover the band padded to
    its clusters and ask for enough shared memory that no two share an
    SM, one ring serving the mesh's strip and the wave's."""
    cfg = gotoh_mesh.band_config(Wd)
    assert (cfg.route, cfg.ch, cfg.threads, cfg.blocks) == (route, ch,
                                                            threads, blocks)
    assert cfg.threads % 32 == 0 and cfg.blocks <= 16
    ring = 4 * gotoh_mesh.STRIP_SLOT * (gotoh_row.CHUNKS[ch][1] + 1)
    assert cfg.smem <= gotoh_row.SMEM_LIMIT
    assert cfg.band >= min(gotoh_mesh.BLOCK_COLS, Wd)
    assert gotoh_row.wave_smem_bytes(threads, ch) == \
        gotoh_row.cluster_smem_bytes(threads, ch) + ring
    if route == "wave":
        assert cfg.bands == gotoh_mesh.WAVE_BANDS
        assert cfg.band == cfg.threads * cfg.ch
        assert gotoh_mesh.covered(cfg) == cfg.bands * cfg.blocks * cfg.band
        assert Wd <= gotoh_mesh.covered(cfg) < Wd + cfg.bands * cfg.blocks \
            * 32 * cfg.ch
        assert cfg.threads <= gotoh_row.WAVE_MAX_THREADS
        assert cfg.smem == max(gotoh_row.cluster_smem_bytes(threads, ch)
                               + ring, gotoh_row.WAVE_SMEM_MIN)
        assert 2 * cfg.smem > gotoh_row.SMEM_LIMIT
        return
    assert cfg.blocks * cfg.band == Wd == cfg.blocks * cfg.threads * cfg.ch
    assert cfg.smem == gotoh_row.cluster_smem_bytes(threads, ch) + ring


@pytest.mark.parametrize("Wd, clusters, threads", [
    (229376, 7, 512),     # the widest blocks at WAVE_BANDS clusters
    (229504, 8, 480),     # one quantum past: an eighth cluster
    (300032, 10, 480),
    (524288, 16, 512),
])
def test_band_config_adds_clusters_past_the_widest_blocks(Wd, clusters,
                                                           threads):
    """Past WAVE_BANDS clusters of blocks of gotoh_row.WAVE_MAX_THREADS
    threads of 8 columns, a band takes as many clusters as keep its
    blocks within that (no width raises below 16 clusters' worth)."""
    cfg = gotoh_mesh.band_config(Wd)
    assert (cfg.route, cfg.bands, cfg.threads, cfg.ch) == ("wave", clusters,
                                                           threads, 8)
    assert Wd <= gotoh_mesh.covered(cfg)
    assert gotoh_mesh.band_config(gotoh_mesh.covered(cfg)) == cfg


@pytest.mark.parametrize("Wd", [0, 100, 2496, 114688 + 64])
def test_band_config_takes_whole_quanta(Wd):
    with pytest.raises(ValueError, match="multiple of 128"):
        gotoh_mesh.band_config(Wd)


@pytest.mark.parametrize("W, n", [
    (1, 2), (128, 8), (1000, 3), (1536, 2), (9984, 4), (9856, 4),
    (4352, 2), (16384, 2), (29184, 2), (20000, 3), (229632, 2),
    (458000, 4)])
def test_band_width_pads_to_what_the_route_covers(W, n):
    """ceil(W / n) rounded up to 128, then to the columns band_config's
    blocks cover; a padded width pads to itself."""
    Wd = gotoh_mesh.band_width(W, n)
    assert Wd % gotoh_row.COL_QUANTUM == 0 and Wd >= -(-W // n)
    cfg = gotoh_mesh.band_config(Wd)
    assert gotoh_mesh.covered(cfg) == Wd
    assert gotoh_mesh.band_width(Wd * n, n) == Wd


@pytest.mark.parametrize("W, n, Wd", [
    (9984, 4, 2560),     # mesh_long's root merge: bands of 2,496 columns
    (1000, 3, 512),      # 334: two blocks of 256
    (4352, 2, 2304),     # 2,176: nine blocks of 256
    (29184, 2, 15360),   # 14,592: fifteen blocks of 1,024
    (33024, 2, 16640),   # 16,512: thirteen blocks of 1,280, 8 a thread
    # the wave route: 7 clusters of 8 blocks of 2,304 columns
    (229632, 2, 129024),  # 114,816
    (236000, 2, 129024),  # 118,000
    (258048, 2, 129024),  # exactly covered
    (600000, 2, 307200),  # 300,000: ten clusters of 3,840-column blocks
])
def test_band_width_pads_past_the_quantum(W, n, Wd):
    """A band that is not a multiple of 128, or that the route's blocks
    do not cover exactly, pads to the next width they do."""
    assert gotoh_mesh.band_width(W, n) == Wd


def _problem(seed, L1, W):
    rng = np.random.default_rng(seed)
    match = (rng.standard_normal((L1, W)) * 3).astype(np.float32)
    pc = (-rng.integers(16, 96, size=(3, W + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, size=(3, L1 + 1)) / 32).astype(np.float32)
    return match, pc, pr


def _mesh_forward(n, match, pc, pr, la, lb, eps, rows):
    """gotoh_mesh.forward on ["cpu"] * n, W padded to n band_width bands
    (as parallel/mesh.py::long_operands pads it), the centering bias left
    to the bands (slope lb / la, eps): (dec [L1, Wp], score, state)."""
    shards = TM.make_mesh(devices=["cpu"] * n).shards
    L1, W = match.shape
    Wd = gotoh_mesh.band_width(W, n)
    Wp = Wd * n
    la_t = torch.tensor([la], dtype=torch.int32)
    lb_t = torch.tensor([lb], dtype=torch.int32)
    slope = lb_t.float() / torch.clamp(la_t.float(), min=1.0)
    prep = gotoh_row.prepare(
        torch.from_numpy(np.pad(pc, ((0, 0), (0, Wp - W)))[None]),
        torch.from_numpy(pr[None]), la_t, lb_t, slope,
        torch.tensor([eps], dtype=torch.float32))
    mp = np.pad(match, ((0, 0), (0, Wp - W)))
    bands = [torch.from_numpy(np.ascontiguousarray(mp[:, d * Wd:
                                                      (d + 1) * Wd]))
             for d in range(n)]
    bands, score, st = gotoh_mesh.forward(shards, bands, prep, la, lb, rows)
    dec = torch.cat([b["dec"] for b in bands], dim=1)
    return dec, score, st


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("L1, W, la, lb", [
    (300, 1000, 300, 1000),          # bands of 334 padded to 384
    (300, 1000, 251, 1000),          # la < L1
    (300, 1000, 300, 90),            # lb inside the first band
    (120, 1000, 0, 1000),            # la = 0
    (120, 1000, 100, 0),             # lb = 0
])
def test_plain_pipeline_is_the_unsplit_row_dp(n, L1, W, la, lb):
    """The plain pipeline at the padded widths and blocks of 64 rows gives
    gotoh_row.plain's bits on the unsplit problem (centering bias on)."""
    match, pc, pr = _problem(7 * n + la, L1, W)
    dec, score, st = _mesh_forward(n, match, pc, pr, la, lb, 1e-3, 64)
    t = lambda x, dt=torch.int32: torch.tensor([x], dtype=dt)
    d1, s1, st1 = gotoh_row.forward_plain(
        torch.from_numpy(match[None]), torch.from_numpy(pc[None]),
        torch.from_numpy(pr[None]), t(la), t(lb),
        t(lb, torch.float32) / torch.clamp(t(la, torch.float32), min=1.0),
        t(1e-3, torch.float32))
    assert torch.equal(dec[:la, :lb], d1[0, :la, :lb])
    assert torch.equal(score.view(torch.int32), s1.view(torch.int32))
    assert torch.equal(st, st1)


@pytest.mark.parametrize("L1, la, lb", [
    (6, 6, 229632),       # the whole row
    (6, 5, 229000),       # la < L1, lb in the second band
    (5, 5, 120000),       # lb in the first band's padding's reach
])
def test_plain_pipeline_past_the_cluster_width_is_the_unsplit_row_dp(
        L1, la, lb):
    """Two bands of 114,816 columns (the wave route's width, padded to
    129,024): the plain pipeline (2 CPU shards, blocks of 4 rows) gives
    gotoh_row.plain's bits on the unsplit 229,632-column problem."""
    match, pc, pr = _problem(lb + la, L1, 229632)
    dec, score, st = _mesh_forward(2, match, pc, pr, la, lb, 1e-3, 4)
    assert dec.shape[1] == 2 * 129024
    t = lambda x, dt=torch.int32: torch.tensor([x], dtype=dt)
    d1, s1, st1 = gotoh_row.forward_plain(
        torch.from_numpy(match[None]), torch.from_numpy(pc[None]),
        torch.from_numpy(pr[None]), t(la), t(lb),
        t(lb, torch.float32) / torch.clamp(t(la, torch.float32), min=1.0),
        t(1e-3, torch.float32))
    assert torch.equal(dec[:la, :lb], d1[0, :la, :lb])
    assert torch.equal(score.view(torch.int32), s1.view(torch.int32))
    assert torch.equal(st, st1)


def test_sharded_long_gotoh_past_the_cluster_width_equals_kalign_tpu():
    """sharded_long_gotoh on 2 CPU shards at 229,632 columns (bands of
    114,816, the wave route's width, padded to 129,024) against
    kalign_tpu's on 2 of conftest's CPU devices: decisions in the valid
    region bitwise, equal end states and walks, scores within rel 1e-5
    (the module's tolerance)."""
    if jax.device_count() < 2:
        pytest.fail("kalign_tpu's mesh tests run on conftest's 8 virtual "
                    "CPU devices")
    L1, W, la, lb = 6, 229632, 6, 229500
    match, pc, pr = _problem(97, L1, W)
    dec, score, st = TM.sharded_long_gotoh(TM.make_mesh(
        devices=["cpu"] * 2), match, pc, pr, la, lb, rows=4)
    jd, js, jst = JM.sharded_long_gotoh(JM.make_mesh(n_devices=2), match,
                                        pc, pr, la, lb)
    assert dec.shape == jd.shape == (L1, W)
    assert np.array_equal(dec[:la, :lb], jd[:la, :lb])
    assert score == pytest.approx(js, rel=1e-5) and st == jst
    steps, k = ttb.walk_rows(torch.from_numpy(dec[None]),
                             torch.tensor([la], dtype=torch.int32),
                             torch.tensor([lb], dtype=torch.int32),
                             torch.tensor([st], dtype=torch.int32),
                             L1 + W + 2)
    jsteps, jk = traceback_batch(jnp.asarray(jd[None]), jnp.asarray([la]),
                                 jnp.asarray([lb]), jnp.asarray([jst]),
                                 L1 + W + 2)
    assert steps[0, :int(k[0])].tolist() == \
        np.asarray(jsteps)[0, :int(np.asarray(jk)[0])].tolist()


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_long_gotoh_at_a_padded_band_equals_kalign_tpu(n):
    """sharded_long_gotoh where W / n is not a multiple of 128 (264 / 3 =
    88 and 264 / 8 = 33 columns, padded to bands of 128) against
    kalign_tpu's on conftest's 8-device CPU mesh, blocks of 24 rows."""
    if jax.device_count() < 8:
        pytest.fail("kalign_tpu's mesh tests run on conftest's 8 virtual "
                    "CPU devices")
    match, pc, pr = _problem(41 + n, 150, 264)
    pc[1] *= 0.2
    pr[1] *= 0.2
    la, lb = 141, 250
    dec, score, st = TM.sharded_long_gotoh(TM.make_mesh(
        devices=["cpu"] * n), match, pc, pr, la, lb, rows=24)
    jd, js, jst = JM.sharded_long_gotoh(JM.make_mesh(n_devices=n), match,
                                        pc, pr, la, lb)
    assert dec.shape == jd.shape == (150, 264)
    assert np.array_equal(dec[:la, :lb], jd[:la, :lb])
    assert score == pytest.approx(js, rel=1e-5) and st == jst
    steps, k = ttb.walk_rows(torch.from_numpy(dec[None]),
                             torch.tensor([la], dtype=torch.int32),
                             torch.tensor([lb], dtype=torch.int32),
                             torch.tensor([st], dtype=torch.int32),
                             150 + 264 + 2)
    jsteps, jk = traceback_batch(jnp.asarray(jd[None]), jnp.asarray([la]),
                                 jnp.asarray([lb]), jnp.asarray([jst]),
                                 150 + 264 + 2)
    assert steps[0, :int(k[0])].tolist() == \
        np.asarray(jsteps)[0, :int(np.asarray(jk)[0])].tolist()


class _NoClusters:
    """A kernel library whose occupancy query says no cluster fits."""

    def kt_gotoh_band_cluster_max_active(self, threads, ch, blocks, out):
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int)).contents.value = 0
        return 0


class _Held:
    """A kernel library whose occupancy query says the card holds `held`
    clusters of a wave plan at once."""

    def __init__(self, held):
        self.held = held

    def kt_gotoh_band_wave_max_active(self, threads, ch, blocks, smem, out):
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int)).contents.value = \
            self.held
        return 0


def _stub_card(monkeypatch, held):
    from contextlib import nullcontext
    from kalign_tpu_torch.gpu import _cuda
    monkeypatch.setattr(_cuda, "lib", lambda: _Held(held))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(gotoh_mesh, "_max_active", {})


@pytest.mark.parametrize("cards, n, held, shared", [
    (1, 2, 15, False),   # an H100's 15: 2 x 7 clusters resident
    (1, 2, 13, True),    # one cluster short: one stream for the card
    (1, 4, 15, True),    # 4 bands of 7 clusters on one card
    (2, 4, 15, False),   # 2 bands a card
    (2, 4, 13, True),
    (4, 4, 7, False),    # a band a card
])
def test_card_streams_keep_every_cluster_of_a_card_resident(
        monkeypatch, cards, n, held, shared):
    """The wave route's launches on one card may run at once, one a shard
    of it: where the card's shards x the plan's clusters exceed what the
    card holds at once (cudaOccupancyMaxActiveClusters, stubbed), every
    shard of that card takes its first shard's stream, so that its
    launches run one at a time; other cards' shards and the cluster route
    keep their own streams."""
    _stub_card(monkeypatch, held)
    devs = [torch.device(f"cuda:{d % cards}") for d in range(n)]
    shards = [gotoh_mesh.Shard(dv, f"stream{d}") for d, dv in
              enumerate(devs)]
    cfg = gotoh_mesh.band_config(114816)
    run = gotoh_mesh.card_streams(shards, cfg)
    first = {}
    for sh in shards:
        first.setdefault(sh.device, sh.stream)
    want = [gotoh_mesh.Shard(sh.device, first[sh.device] if shared
                             else sh.stream) for sh in shards]
    assert run == want
    assert gotoh_mesh.card_streams(shards, gotoh_mesh.band_config(8192)) \
        == shards
    cpu = [gotoh_mesh.Shard(torch.device("cpu"), None)] * n
    assert gotoh_mesh.card_streams(cpu, cfg) == cpu


def test_a_wave_plan_the_card_cannot_hold_raises(monkeypatch):
    """No fallback: a band whose clusters the card cannot hold all at
    once raises (a cluster waits on the one to its left), it does not
    drop to another route or to the plain version."""
    _stub_card(monkeypatch, 6)
    shards = [gotoh_mesh.Shard(torch.device("cuda:0"), "s0")]
    with pytest.raises(RuntimeError, match="7 times at once"):
        gotoh_mesh.card_streams(shards, gotoh_mesh.band_config(114816))


def test_an_unschedulable_cluster_raises(monkeypatch):
    """No fallback: a cluster plan the card cannot hold raises, it does
    not drop to the block route or to the plain version."""
    from kalign_tpu_torch.gpu import _cuda
    monkeypatch.setattr(_cuda, "lib", lambda: _NoClusters())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(gotoh_mesh, "_max_active", {})
    with pytest.raises(RuntimeError, match="cannot schedule a cluster"):
        gotoh_mesh.schedulable(gotoh_mesh.band_config(8192))
