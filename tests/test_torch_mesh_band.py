"""The band kernel's plan and padding (kalign_tpu_torch/gpu/gotoh_mesh.py)
on the CPU: which route a band's width takes, the padded band widths,
and the column-sharded pipeline's plain version at those widths against
the unsplit row DP (gotoh_row.plain) and against kalign_tpu's
sharded_long_gotoh on conftest's 8-device CPU mesh.

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
    (114816, "block", 1, 1024, 1),
])
def test_band_config_picks_the_route_by_width(Wd, route, ch, threads,
                                               blocks):
    """A cluster of one block of 4 columns a thread up to BLOCK_COLS; past
    it a cluster of at most 16 blocks of at least BLOCK_COLS columns (8 a
    thread past 1,024 a block) up to CLUSTER_MAX_WIDTH; the block route
    past it.  A cluster's blocks cover the band exactly and fit the
    card's shared memory (the strip ring included)."""
    cfg = gotoh_mesh.band_config(Wd)
    assert (cfg.route, cfg.ch, cfg.threads, cfg.blocks) == (route, ch,
                                                            threads, blocks)
    if route == "block":
        assert cfg.band == Wd and cfg.threads % 32 == 0
        return
    assert cfg.blocks * cfg.band == Wd == cfg.blocks * cfg.threads * cfg.ch
    assert cfg.threads % 32 == 0 and cfg.blocks <= 16
    ring = 4 * gotoh_mesh.STRIP_SLOT * (gotoh_row.CHUNKS[ch][1] + 1)
    assert cfg.smem <= gotoh_row.SMEM_LIMIT
    assert cfg.band >= min(gotoh_mesh.BLOCK_COLS, Wd)
    assert cfg.smem == gotoh_row.cluster_smem_bytes(threads, ch) + ring


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
    assert Wd - -(-W // n) < gotoh_row.COL_QUANTUM or \
        gotoh_mesh.band_config(Wd).route != "block"
    cfg = gotoh_mesh.band_config(Wd)
    assert cfg.route == "block" or cfg.blocks * cfg.band == Wd
    assert gotoh_mesh.band_width(Wd * n, n) == Wd


@pytest.mark.parametrize("W, n, Wd", [
    (9984, 4, 2560),     # mesh_long's root merge: bands of 2,496 columns
    (1000, 3, 512),      # 334: two blocks of 256
    (4352, 2, 2304),     # 2,176: nine blocks of 256
    (29184, 2, 15360),   # 14,592: fifteen blocks of 1,024
    (33024, 2, 16640),   # 16,512: thirteen blocks of 1,280, 8 a thread
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


def test_an_unschedulable_cluster_raises(monkeypatch):
    """No fallback: a cluster plan the card cannot hold raises, it does
    not drop to the block route or to the plain version."""
    from kalign_tpu_torch.gpu import _cuda
    monkeypatch.setattr(_cuda, "lib", lambda: _NoClusters())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(gotoh_mesh, "_max_active", {})
    with pytest.raises(RuntimeError, match="cannot schedule a cluster"):
        gotoh_mesh.schedulable(gotoh_mesh.band_config(8192))
