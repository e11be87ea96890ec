"""The row Gotoh kernel's cluster instantiation on the CPU: its band
schedule as a PyTorch model (``band_split_plain``: each band of a row
computed from its own columns and the halo the band on its left hands
over, as csrc/gotoh_row.cu::gotoh_row_cluster_kernel does) held bitwise
against gpu/gotoh_row.py::plain and against kalign_tpu's XLA scan
(tpu/gotoh.py::gotoh_forward) on an 8,192-wide problem; the plan
(``cluster_config``) over every width it takes; and the wrapper's refusal
of a cluster the card cannot schedule."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kalign_tpu.tpu import gotoh as jgotoh
from kalign_tpu_torch.gpu import _cuda
from kalign_tpu_torch.gpu import gotoh_row
from kalign_tpu_torch.gpu import traceback as tb

NEG = gotoh_row.NEG


def band_split_plain(match, prep, la, lb, S, band=None, drop_last=False):
    """gotoh_row.plain with each row cut into S bands of ``band`` columns
    (default ceil(W / S)).  Band k sees only its own columns' state and,
    from band k - 1, the halo of this row (the prefix max of u over every
    column left of band k, the u at its left neighbour column) and of the
    previous row (A, GA and GB at that column: the diagonal left edge).
    drop_last (a mutation) leaves a band's last column out of the carry it
    hands on."""
    B, L1p, W = match.shape
    f32 = dict(dtype=torch.float32, device=match.device)
    band = band or -(-W // S)
    C_norm, C_term, gnC_norm, gnC_term, goB_s = prep["colpen"]
    rowpen = prep["rowpen"]
    cols = torch.arange(1, W + 1, device=match.device)[None, :]
    neg = torch.full((), NEG, **f32)
    negc = torch.full((B, 1), NEG, **f32)
    spans = [(lo, min(lo + band, W)) for lo in range(0, W, band)]
    A = [torch.full((B, hi - lo), NEG, **f32) for lo, hi in spans]
    GA = [prep["ga0"][:, lo:hi].clone() for lo, hi in spans]
    GB = [torch.full((B, hi - lo), NEG, **f32) for lo, hi in spans]
    # the previous row's A, GA, GB at each band's left neighbour column
    edge = [None] + [(negc, prep["ga0"][:, lo - 1:lo], negc)
                     for lo, _ in spans[1:]]
    dec = torch.zeros((B, L1p, W), dtype=torch.int8, device=match.device)
    for r in range(L1p):
        row = r + 1
        goA_i, geA_i, tgeA_i, goA_prev, gb0_prev = (
            rowpen[:, r, q:q + 1] for q in range(5))
        last = (la == row)[:, None]
        valid = (row <= la)[:, None]
        carry = torch.full((B, 1), -float("inf"), **f32)
        lu = negc
        new_edge = [None] * len(spans)
        for k, (lo, hi) in enumerate(spans):
            c = cols[:, lo:hi]
            m = match[:, r, lo:hi] - torch.abs(
                prep["cols_eps"][:, lo:hi] - prep["row_term"][:, r:r + 1])
            if k == 0:
                eA = torch.full((B, 1), 0.0 if row == 1 else NEG, **f32)
                eGA, eGB = negc, gb0_prev
            else:
                eA, eGA, eGB = edge[k]
            diagA = torch.cat([eA, A[k][:, :-1]], dim=1)
            diagGA = torch.cat([eGA, GA[k][:, :-1]], dim=1) + goB_s[:, lo:hi]
            diagGB = torch.cat([eGB, GB[k][:, :-1]], dim=1) + goA_prev
            best01 = torch.maximum(diagA, diagGA)
            A_row = torch.maximum(best01, diagGB) + m
            is_term = c == lb[:, None]
            ge_eff = torch.where(is_term, tgeA_i, geA_i)
            go_eff = torch.where(is_term, tgeA_i, goA_i)
            gb_e = GB[k] + ge_eff
            gb_o = A[k] + go_eff
            GB_row = torch.maximum(gb_e, gb_o)
            C = torch.where(last, C_term[:, lo:hi], C_norm[:, lo:hi])
            gnC = torch.where(last, gnC_term[:, lo:hi], gnC_norm[:, lo:hi])
            u = torch.where(c < lb[:, None], A_row + gnC, neg)
            cm = torch.cummax(u, dim=1).values
            if k == 0:
                cm_s = torch.cat([negc, cm[:, :-1]], dim=1)
                u_s = torch.cat([negc, u[:, :-1]], dim=1)
            else:
                cm_s = torch.cat([carry, torch.maximum(carry, cm[:, :-1])],
                                 dim=1)
                u_s = torch.cat([lu, u[:, :-1]], dim=1)
            GA_row = cm_s + C
            d = torch.where(diagGB >= best01, 2,
                            torch.where(diagGA >= diagA, 1, 0))
            d = d | torch.where(cm_s > u_s, 4, 0) | torch.where(gb_e > gb_o,
                                                               8, 0)
            dec[:, r, lo:hi] = d.to(torch.int8)
            A[k] = torch.where(valid, A_row, A[k])
            GA[k] = torch.where(valid, GA_row, GA[k])
            GB[k] = torch.where(valid, GB_row, GB[k])
            # the halo for band k + 1
            kept = cm[:, -2:-1] if drop_last and hi - lo > 1 else cm[:, -1:]
            carry = torch.maximum(carry, kept)
            lu = u[:, -1:]
            if k + 1 < len(spans):
                new_edge[k + 1] = (A[k][:, -1:], GA[k][:, -1:],
                                   GB[k][:, -1:])
        edge = new_edge

    # the end state from the band holding column lb - 1
    whole = [torch.cat(x, dim=1) for x in (A, GA, GB)]
    idx = (lb.long() - 1).clamp(min=0, max=W - 1)[:, None]
    in_range = (lb >= 1) & (lb <= W)

    def pick(x):
        return torch.where(in_range,
                           torch.maximum(x.gather(1, idx)[:, 0], neg), neg)

    ea, ega, egb = (pick(x) for x in whole)
    score = torch.maximum(torch.maximum(ea, ega), egb)
    state = torch.where(ega > ea, torch.where(egb > ega, 2, 1),
                        torch.where(egb > ea, 2, 0)).to(torch.int32)
    return dec, score, state


def _problem(rng, B, L1p, L2p, la, lb):
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
    eps = np.full(B, 1e-3, np.float32)
    return tuple(t(x) for x in (match, pc, pr, la, lb, slope, eps))


def _run(dp, args):
    return gotoh_row.run_dp(gotoh_row.prepare, dp, *args)


def _same(a, b):
    """Bitwise scores, equal end states, equal decisions everywhere."""
    (da, sa, sta), (db, sb, stb) = a, b
    return (torch.equal(sa.view(torch.int32), sb.view(torch.int32))
            and torch.equal(sta, stb) and torch.equal(da, db))


def _edge_lengths(L1p, W, band):
    """la = 0, la = 1, lb = 0, lb at a band's right edge and one either
    side, lb inside the first band (bands wholly past it), la < L1p (the
    last row's C_term switch inside the rows), full lengths."""
    edge = min(band, W)
    la = [0, 1, L1p, L1p // 2, L1p - 1, L1p, 7, L1p]
    lb = [W // 2, W, 0, edge, edge - 1, min(edge + 1, W), 3, W]
    return la, lb


@pytest.mark.parametrize("S", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("W", [128, 640, 2048])
def test_band_schedule_bitwise_equal_to_plain(S, W):
    rng = np.random.default_rng(1000 * S + W)
    L1p = 64 if W > 128 else 128
    band = -(-W // S)
    la, lb = _edge_lengths(L1p, W, band)
    args = _problem(rng, len(la), L1p, W, la, lb)
    ref = _run(gotoh_row.plain, args)
    got = _run(lambda m, p, a, b: band_split_plain(m, p, a, b, S), args)
    assert _same(got, ref)


def test_band_schedule_at_the_kernels_bands():
    """The plan's own band widths (multiples of 128) at a width whose last
    band lies wholly past the row: 7,424 columns in 16 bands of 512 (the
    long family's merges), lb at the 14th band's edge."""
    rng = np.random.default_rng(5)
    W, L1p = 7424, 16
    cfg = gotoh_row.cluster_config(2, W)
    assert (cfg.blocks, cfg.band) == (16, 512)
    args = _problem(rng, 2, L1p, W, [16, 9], [7 * 1024, W])
    ref = _run(gotoh_row.plain, args)
    got = _run(lambda m, p, a, b: band_split_plain(
        m, p, a, b, cfg.blocks, cfg.band), args)
    assert _same(got, ref)


def test_band_schedule_fails_without_the_last_column_in_the_carry():
    """Mutation check: a carry that leaves out the left band's last column
    changes GA at the next band, so decisions or scores differ."""
    rng = np.random.default_rng(9)
    W, L1p, S = 512, 128, 4
    la = [L1p] * 8
    lb = [W] * 8
    args = _problem(rng, 8, L1p, W, la, lb)
    ref = _run(gotoh_row.plain, args)
    assert _same(_run(lambda m, p, a, b: band_split_plain(m, p, a, b, S),
                      args), ref)
    bad = _run(lambda m, p, a, b: band_split_plain(m, p, a, b, S,
                                                   drop_last=True), args)
    assert not _same(bad, ref)


def test_band_schedule_matches_xla_scan_at_8192_columns():
    """As test_row_plain_matches_xla_scores_and_paths: scores within rel
    1e-5 and identical paths, the 8,192-wide problem cut into the plan's
    16 bands of 512."""
    B, L1p, L2p = 2, 64, 8192
    rng = np.random.default_rng(B + L1p + L2p)
    match = rng.normal(scale=3.0, size=(B, L1p, L2p)).astype(np.float32)
    pc = -np.abs(rng.normal(loc=5.0, size=(B, 3, L2p + 1))).astype(np.float32)
    pr = -np.abs(rng.normal(loc=5.0, size=(B, 3, L1p + 1))).astype(np.float32)
    pc[:, 1] *= 0.2
    pr[:, 1] *= 0.2
    la = rng.integers(1, L1p + 1, size=B).astype(np.int32)
    lb = rng.integers(1, L2p + 1, size=B).astype(np.int32)
    cfg = gotoh_row.cluster_config(B, L2p)
    assert (cfg.blocks, cfg.band) == (16, 512)
    t = torch.from_numpy
    dec, score, st = gotoh_row.run_dp(
        gotoh_row.prepare, lambda m, p, a, b: band_split_plain(
            m, p, a, b, cfg.blocks, cfg.band),
        t(match), t(pc), t(pr), t(la), t(lb), None, None)
    steps, n = tb.walk_rows(dec, t(la), t(lb), st, L1p + L2p + 2)
    for k in range(B):
        dec_j, score_j, st_j = jgotoh.gotoh_forward(
            jnp.asarray(match[k]), jnp.asarray(pc[k, 0]),
            jnp.asarray(pc[k, 1]), jnp.asarray(pc[k, 2]),
            jnp.asarray(pr[k, 0]), jnp.asarray(pr[k, 1]),
            jnp.asarray(pr[k, 2]), int(la[k]), int(lb[k]))
        path = jgotoh.traceback(np.asarray(dec_j), int(la[k]), int(lb[k]),
                                int(st_j))
        assert float(score[k]) == pytest.approx(float(score_j), rel=1e-5), k
        assert steps[k, :n[k]].tolist() == path, k


@pytest.mark.parametrize("B", [1, 2, 8, 64])
def test_cluster_config_covers_every_width(B):
    """Every width from 7,296 to 114,688 (steps of 128) gets a cluster
    plan whose bands cover the row, each a multiple of 128 columns (of
    whole warps of its columns per thread), at most 16 of them, within the
    instantiation's threads and Hopper's shared memory, sized by the
    kernel's own formula; S the largest that keeps B * S within 132 blocks,
    or the least that keeps bands within 7,168 columns; 4 columns a
    thread up to bands of 1,024; wider rows get the wave plan."""
    fit = max((s for s in (2, 4, 8, 16) if B * s <= 132), default=2)
    for L2p in range(7296, gotoh_row.CLUSTER_MAX_WIDTH + 1, 128):
        cfg = gotoh_row.launch_config(B, L2p)
        assert cfg.route == "cluster"
        assert cfg == gotoh_row.cluster_config(B, L2p)
        S, band = cfg.blocks, cfg.band
        assert S in (2, 4, 8, 16)
        assert band % 128 == 0 and band % (32 * cfg.ch) == 0
        assert band == cfg.threads * cfg.ch
        assert S * band >= L2p
        assert band - -(-L2p // S) < 32 * cfg.ch
        max_threads, stages = gotoh_row.CHUNKS[cfg.ch]
        assert cfg.threads % 32 == 0 and cfg.threads <= max_threads
        assert cfg.smem == (4 * gotoh_row.HALO_SLOTS * (4 + 8 + 1)
                            + 4 * ((4 + stages) * cfg.threads * cfg.ch
                                   + cfg.threads // 32 * 2 * 5))
        assert cfg.smem <= gotoh_row.SMEM_LIMIT
        need = min(s for s in (2, 4, 8, 16) if s * 7168 >= L2p)
        assert S == max(fit, need)
        assert cfg.ch == (4 if band <= 1024 else 8)
    for L2p in (114816, 131072, 200064):
        cfg = gotoh_row.launch_config(B, L2p)
        assert cfg.route == "wave" and cfg == gotoh_row.wave_config(L2p)
        assert cfg.band == cfg.threads * cfg.ch <= gotoh_row.BAND_MAX
        assert cfg.bands * cfg.blocks * cfg.band >= L2p


def test_cluster_launch_raises_where_the_card_cannot_schedule_it(
        monkeypatch):
    """A plan cudaOccupancyMaxActiveClusters gives 0 clusters raises; it
    does not fall back to another route."""
    class NoRoom:
        @staticmethod
        def kt_gotoh_row_cluster_max_active(threads, ch, blocks, out):
            out._obj.value = 0
            return 0

    monkeypatch.setattr(_cuda, "lib", lambda: NoRoom)
    monkeypatch.setattr(gotoh_row, "_max_active", {})
    cfg = gotoh_row.cluster_config(8, 8192)
    with pytest.raises(RuntimeError, match="cannot schedule"):
        gotoh_row.cluster_schedulable(cfg)
    assert gotoh_row.cluster_launches == 0
