"""The row DP's wave route (kalign_tpu_torch/gpu/gotoh_wave.py, past
114,688 columns) on the CPU: its plain version — bands of columns over
blocks of rows, the match asked for one block at a time, the state
carried between blocks, each band fed by its left neighbour's strip, as
csrc/gotoh_row_wave.cu runs it — held bitwise against gotoh_row.plain on
the unsplit problem and against kalign_tpu's XLA scan; the plan
(wave_config) and its occupancy check; the engine's memory guard.
tests/test_torch_gotoh_wave_family.py runs long families through the
engine's wide routes.

Tolerances: the port against itself bitwise (decisions on every row
< la, scores' float bits, end states); against kalign_tpu's scan scores
within rel 1e-5 (it forms u as (A + go) - C where the port adds the
precomputed go - C) and identical paths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kalign_tpu.tpu import gotoh as jgotoh
from kalign_tpu_torch.gpu import _cuda, gotoh_row, gotoh_wave
from kalign_tpu_torch.gpu import engine as TGE
from kalign_tpu_torch.gpu import traceback as tb


def _problem(rng, B, L1p, L2p, la, lb, eps=1e-3):
    """Random match scores and random (not dyadic) penalties, centering
    bias on: the prefix sums round, as on real inputs."""
    t = torch.from_numpy
    match = rng.normal(scale=3.0, size=(B, L1p, L2p)).astype(np.float32)
    pc = -np.abs(rng.normal(loc=5.0, size=(B, 3, L2p + 1))).astype(np.float32)
    pr = -np.abs(rng.normal(loc=5.0, size=(B, 3, L1p + 1))).astype(np.float32)
    pc[:, 1] *= 0.2
    pr[:, 1] *= 0.2
    la = np.asarray(la, np.int32)
    lb = np.asarray(lb, np.int32)
    slope = (lb / np.maximum(la, 1)).astype(np.float32)
    return tuple(t(x) for x in (match, pc, pr, la, lb, slope,
                                np.full(B, eps, np.float32)))


def _wave(match, prep, la, lb, cfg, rows):
    return gotoh_wave.plain(lambda b, r0, r1: match[b, r0:r1], prep, la, lb,
                            cfg, rows)


def _same_valid(a, b, la):
    """Decisions equal on every row < la, scores' bits and end states."""
    (da, sa, sta), (db, sb, stb) = a, b
    rows = all(torch.equal(da[k, :int(la[k])], db[k, :int(la[k])])
               for k in range(len(la)))
    return (rows and torch.equal(sa.view(torch.int32), sb.view(torch.int32))
            and torch.equal(sta, stb))


def _cfg(band, bands, blocks=1):
    """A wave plan of ``bands`` clusters of ``blocks`` blocks of ``band``
    columns (4 a thread)."""
    return gotoh_row.WaveLaunch("wave", band // 4, 4, 0, blocks, band, bands)


def _edge_lengths(L1p, W, unit, R):
    """la = 0, la = 1, la at a block of rows' edge and one past, la <
    L1p, full; lb = 0, lb at a band's right edge and one either side, lb
    inside the first band (the bands past it wholly past lb), lb = W."""
    la = [0, 1, min(R, L1p), min(R + 1, L1p), L1p - 1, L1p, 7, L1p,
          L1p // 2]
    lb = [W // 2, W, 0, unit, unit - 1, unit + 1, 3, W, 2 * unit]
    return la, lb


@pytest.mark.parametrize("W, unit, R", [
    (384, 128, 16),     # three bands, several blocks of rows
    (640, 128, 64),     # five bands, one block of rows
    (640, 256, 7),      # the last band past the row, blocks of 7 rows
    (1024, 1024, 20),   # one band: the row kernel over blocks of rows
])
def test_wave_plain_bitwise_equal_to_row_plain(W, unit, R):
    rng = np.random.default_rng(W + unit + R)
    L1p = 64
    la, lb = _edge_lengths(L1p, W, unit, R)
    match, pc, pr, la_t, lb_t, slope, eps = _problem(rng, len(la), L1p, W,
                                                     la, lb)
    prep = gotoh_row.prepare(pc, pr, la_t, lb_t, slope, eps)
    ref = gotoh_row.run_dp(gotoh_row.prepare, gotoh_row.plain, match, pc,
                           pr, la_t, lb_t, slope, eps)
    dec, score, st = _wave(match, prep, la_t, lb_t,
                           _cfg(unit, -(-W // unit)), R)
    score, st = gotoh_row.fix_lb0(score, st, prep, lb_t)
    assert _same_valid((dec, score, st), ref, la)


def test_wave_plain_fails_on_the_wrong_rows():
    """Mutation check: a source that hands every block of rows the
    match's first rows (not its own) gives other decisions or scores, so
    the blocks' rows reach the DP where they belong."""
    rng = np.random.default_rng(4)
    L1p, W = 48, 256
    la, lb = [48] * 4, [256, 200, 130, 256]
    match, pc, pr, la_t, lb_t, slope, eps = _problem(rng, 4, L1p, W, la, lb)
    prep = gotoh_row.prepare(pc, pr, la_t, lb_t, slope, eps)
    ref = gotoh_row.plain(match, prep, la_t, lb_t)
    cfg = _cfg(128, 2)
    assert _same_valid(_wave(match, prep, la_t, lb_t, cfg, 16), ref, la)
    bad = gotoh_wave.plain(lambda b, r0, r1: match[b, :r1 - r0], prep, la_t,
                           lb_t, cfg, 16)
    assert not _same_valid(bad, ref, la)


def test_wave_plain_matches_xla_scan_at_8192_columns():
    """As the cluster route's test: scores within rel 1e-5 and identical
    paths, the 8,192-wide problem in 8 bands of 1,024 over blocks of 16
    rows."""
    B, L1p, L2p = 2, 64, 8192
    rng = np.random.default_rng(B + L1p + L2p)
    la = rng.integers(1, L1p + 1, size=B).astype(np.int32)
    lb = rng.integers(1, L2p + 1, size=B).astype(np.int32)
    match, pc, pr, la_t, lb_t, _, _ = _problem(rng, B, L1p, L2p, la, lb)
    dec, score, st = gotoh_row.run_dp(
        gotoh_row.prepare, lambda m, p, a, b: _wave(
            m, p, a, b, _cfg(1024, 8), 16), match, pc, pr, la_t, lb_t, None,
        None)
    steps, n = tb.walk_rows(dec, la_t, lb_t, st, L1p + L2p + 2)
    for k in range(B):
        dec_j, score_j, st_j = jgotoh.gotoh_forward(
            jnp.asarray(match[k].numpy()), *(jnp.asarray(pc[k, i].numpy())
                                             for i in range(3)),
            *(jnp.asarray(pr[k, i].numpy()) for i in range(3)), int(la[k]),
            int(lb[k]))
        path = jgotoh.traceback(np.asarray(dec_j), int(la[k]), int(lb[k]),
                                int(st_j))
        assert float(score[k]) == pytest.approx(float(score_j), rel=1e-5), k
        assert steps[k, :n[k]].tolist() == path, k


@pytest.mark.parametrize("L2p", [114816, 131072, 156032, 200064, 262144])
def test_launch_config_routes_past_the_cluster_widths_to_the_wave(L2p):
    """Past CLUSTER_MAX_WIDTH every width takes the wave: clusters of
    WAVE_CLUSTER blocks of at least WAVE_BLOCK_COLS columns (whole warps,
    4 columns a thread up to 1,024), at most WAVE_BANDS of them covering
    the row, one block an SM by its shared memory."""
    for B in (1, 2, 8):
        cfg = gotoh_row.launch_config(B, L2p)
        assert cfg.route == "wave" and cfg == gotoh_row.wave_config(L2p)
    S, w = cfg.blocks, cfg.band
    assert S == gotoh_row.WAVE_CLUSTER and w >= gotoh_row.WAVE_BLOCK_COLS
    assert w == cfg.threads * cfg.ch and cfg.threads % 32 == 0
    assert cfg.ch == (4 if w <= 1024 else 8)
    assert cfg.bands <= gotoh_row.WAVE_BANDS
    assert cfg.bands * S * w >= L2p > (cfg.bands - 1) * S * w
    assert cfg.smem == max(gotoh_row.wave_smem_bytes(cfg.threads, cfg.ch),
                           gotoh_row.WAVE_SMEM_MIN)
    assert 2 * (cfg.smem + 1024) > 233472 and cfg.smem <= \
        gotoh_row.SMEM_LIMIT


def test_wave_config_narrows_to_the_clusters_the_card_holds(monkeypatch):
    """schedulable re-plans over as many bands as the occupancy query
    says are resident at once, and raises where it says none is."""
    held = {"n": 12}

    class Lib:
        @staticmethod
        def kt_gotoh_row_wave_max_active(threads, ch, blocks, smem, out):
            out._obj.value = held["n"]
            return 0

    monkeypatch.setattr(_cuda, "lib", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(gotoh_wave, "_max_active", {})
    cfg = gotoh_wave.schedulable(156032)
    assert cfg.bands <= 12 and cfg.bands * cfg.blocks * cfg.band >= 156032
    held["n"] = 0
    monkeypatch.setattr(gotoh_wave, "_max_active", {})
    with pytest.raises(RuntimeError, match="cannot hold"):
        gotoh_wave.schedulable(131072)
    assert gotoh_wave.launches == 0


def test_block_rows_keep_a_block_within_its_bytes(monkeypatch):
    """As many rows as keep a block's match within BLOCK_BYTES, at least
    MIN_ROWS, at most the problem's."""
    assert gotoh_wave.block_rows(156032, 156032) == \
        (2 << 30) // (4 * 156032)
    assert gotoh_wave.block_rows(64, 131072) == 64
    assert gotoh_wave.block_rows(100000, 917504) == \
        (2 << 30) // (4 * 917504)
    monkeypatch.setattr(gotoh_wave, "BLOCK_BYTES", 1 << 20)
    assert gotoh_wave.block_rows(100000, 131072) == gotoh_wave.MIN_ROWS


def test_memory_guard_names_the_width(monkeypatch):
    """A wide launch whose one problem the card cannot hold raises before
    it allocates, naming the width; no host fallback."""
    rng = np.random.default_rng(2)
    t = torch.from_numpy
    L1p, L2p = 128, 7296
    lhs = t(rng.random((1, L1p, 23), dtype=np.float32))
    rhs = t(rng.random((1, L2p, 23), dtype=np.float32))
    pc = -t(rng.random((1, 3, L2p + 1), dtype=np.float32))
    pr = -t(rng.random((1, 3, L1p + 1), dtype=np.float32))
    la, lb = t(np.array([L1p], np.int32)), t(np.array([L2p], np.int32))
    eps = torch.full((1,), 1e-3)
    monkeypatch.setattr(TGE, "card_bytes", lambda dev: 1 << 20)
    with pytest.raises(MemoryError, match=f"{L1p} x {L2p}"):
        TGE.row_route(lhs, rhs, pc, pr, la, lb, eps, None)
    monkeypatch.setattr(TGE, "card_bytes",
                        lambda dev: TGE.problem_bytes(L1p, L2p))
    steps, n, score = TGE.row_route(lhs, rhs, pc, pr, la, lb, eps, None)
    assert int(n[0]) >= L2p
