"""The traceback walk's plain version (gpu/traceback.py, the walk of
csrc/traceback.cu) against kalign_tpu's device walks traceback_batch and
traceback_lanewise, on identical decisions: exact steps and counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kalign_tpu.tpu.gotoh_lanewise import gotoh_forward_direct_np
from kalign_tpu.tpu.traceback import traceback_batch, traceback_lanewise
from kalign_tpu_torch.gpu import gotoh_lanewise
from kalign_tpu_torch.gpu import traceback as tb
from kalign_tpu_torch.gpu.engine import GpuEngine


def _decisions(seed, B, L1p, L2p):
    """Real forward decisions (with near-random ragged lengths, lb = 0
    and la = 1 cases) and their end states."""
    rng = np.random.default_rng(seed)
    match = (rng.normal(size=(B, L1p, L2p)) * 3).astype(np.float32)
    pc = (-rng.integers(16, 96, size=(B, 3, L2p + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, size=(B, 3, L1p + 1)) / 32).astype(np.float32)
    la = rng.integers(1, L1p + 1, size=B).astype(np.int32)
    lb = rng.integers(0, L2p + 1, size=B).astype(np.int32)
    la[:4] = 1
    dec, _, st = gotoh_forward_direct_np(match, pc, pr, la, lb)
    return dec, la, lb, st


def _random_decisions(seed, B, L1p, L2p):
    """Arbitrary valid decision bytes: walks take every branch."""
    rng = np.random.default_rng(seed)
    dec = (rng.integers(0, 3, size=(B, L1p, L2p))
           | (rng.integers(0, 2, size=(B, L1p, L2p)) << 2)
           | (rng.integers(0, 2, size=(B, L1p, L2p)) << 3)).astype(np.uint8)
    la = rng.integers(0, L1p + 1, size=B).astype(np.int32)
    lb = rng.integers(0, L2p + 1, size=B).astype(np.int32)
    st = rng.integers(0, 3, size=B).astype(np.int32)
    return dec, la, lb, st


def _pack_tpu(dec):
    """[B, L1p, L2p] -> kalign_tpu's lanewise layout
    [NB, L1p, L2p/4, 8, 128] (4 nibbles per int32)."""
    B, L1p, L2p = dec.shape
    d = dec.astype(np.int64).reshape(B // 1024, 8, 128, L1p, L2p // 4, 4)
    w = sum(d[..., u] << (4 * u) for u in range(4))
    w = np.transpose(w, (0, 3, 4, 1, 2))
    return np.where(w >= 2 ** 31, w - 2 ** 32, w).astype(np.int32)


def test_row_walk_matches_traceback_batch():
    for dec, la, lb, st in (_decisions(1, 256, 24, 16),
                            _random_decisions(2, 256, 24, 16)):
        ms = 24 + 16 + 2
        s_j, n_j = traceback_batch(jnp.asarray(dec.astype(np.int8)),
                                   jnp.asarray(la), jnp.asarray(lb),
                                   jnp.asarray(st), ms)
        t = torch.from_numpy
        s_t, n_t = tb.walk_rows(t(dec.astype(np.int8)), t(la), t(lb), t(st),
                                ms)
        assert np.array_equal(s_t.numpy(), np.asarray(s_j))
        assert np.array_equal(n_t.numpy(), np.asarray(n_j))


def test_lanewise_walk_matches_traceback_lanewise():
    for dec, la, lb, st in (_decisions(3, 1024, 16, 16),
                            _random_decisions(4, 1024, 16, 16)):
        ms = 16 + 16 + 2
        s_j, n_j = traceback_lanewise(jnp.asarray(_pack_tpu(dec)),
                                      jnp.asarray(la), jnp.asarray(lb),
                                      jnp.asarray(st), ms)
        t = torch.from_numpy
        s_t, n_t = tb.walk_lanewise(gotoh_lanewise.pack_dec(t(dec)), t(la),
                                    t(lb), t(st), ms)
        assert np.array_equal(s_t.numpy(), np.asarray(s_j))
        assert np.array_equal(n_t.numpy(), np.asarray(n_j))
        # each walk consumes exactly la rows and lb columns
        s = s_t.numpy()
        assert np.array_equal(((s == 0) | (s == 2)).sum(1), la)
        assert np.array_equal(((s == 0) | (s == 1)).sum(1), lb)


def _walk_decisions(seed, B, L, p_diag, p_ext):
    """Decisions whose walks are longer than the kernel's windows
    (tb.WINDOW): near-diagonal (p_diag high) or gap-heavy (p_diag low,
    gaps extending with probability p_ext); lengths up to L, with la = 0,
    lb = 0 and lengths just past a window's side."""
    rng = np.random.default_rng(seed)
    shape = (B, L, L)
    a = np.where(rng.random(shape) < p_diag, 0, rng.integers(1, 3, shape))
    dec = (a | ((rng.random(shape) < p_ext) << 2)
           | ((rng.random(shape) < p_ext) << 3)).astype(np.uint8)
    la = rng.integers(L - 40, L + 1, size=B).astype(np.int32)
    lb = rng.integers(L - 40, L + 1, size=B).astype(np.int32)
    la[0], lb[1] = 0, 0
    la[2:4], lb[2:4] = (65, 129), (65, 129)
    st = rng.integers(0, 3, size=B).astype(np.int32)
    return dec, la, lb, st


@pytest.mark.parametrize("p_diag,p_ext", [(0.9, 0.5), (0.2, 0.9)],
                         ids=["near_diagonal", "gap_heavy"])
@pytest.mark.parametrize("lanewise", [False, True], ids=["rows", "lanewise"])
def test_walks_longer_than_a_window_match_jax(lanewise, p_diag, p_ext):
    """Walks of up to 320 steps at L1p = L2p = 160 (past both layouts'
    windows) against traceback_batch / traceback_lanewise."""
    L = 160
    B = 1024 if lanewise else 96
    dec, la, lb, st = _walk_decisions(11 + lanewise, B, L, p_diag, p_ext)
    ms = 2 * L + 2
    t = torch.from_numpy
    if lanewise:
        s_j, n_j = traceback_lanewise(jnp.asarray(_pack_tpu(dec)),
                                      jnp.asarray(la), jnp.asarray(lb),
                                      jnp.asarray(st), ms)
        s_t, n_t = tb.walk_lanewise(gotoh_lanewise.pack_dec(t(dec)), t(la),
                                    t(lb), t(st), ms)
    else:
        s_j, n_j = traceback_batch(jnp.asarray(dec.astype(np.int8)),
                                   jnp.asarray(la), jnp.asarray(lb),
                                   jnp.asarray(st), ms)
        s_t, n_t = tb.walk_rows(t(dec.astype(np.int8)), t(la), t(lb), t(st),
                                ms)
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    assert np.array_equal(n_t.numpy(), np.asarray(n_j))
    assert int(n_t.max()) > max(tb.WINDOW)


@pytest.mark.parametrize("lanewise", [False, True], ids=["rows", "lanewise"])
def test_walk_launch_plan_fits_shared_memory(lanewise):
    """launch_plan for every batch and width the engine can route to the
    walk: the row kernel's widths up to 7,040 columns on either side, the
    lanewise kernel's by its routing rule; max_steps = L1p + L2p + 2."""
    rows, cols = tb.WINDOW
    assert cols & (cols - 1) == 0 and cols % (8 if lanewise else 16) == 0
    if lanewise:
        widths = [(B, L1p, L2p) for B in (1024, 2048, 4096)
                  for L1p in range(128, 2049, 128)
                  for L2p in range(128, 2049, 128)
                  if GpuEngine.lanewise_ok(B, L1p, L2p)]
        assert widths
    else:
        widths = [(B, L1p, L2p) for B in (1, 8, 64, 512)
                  for L1p in range(128, 7041, 128)
                  for L2p in range(128, 7041, 128)]
    for B, L1p, L2p in widths:
        plan = tb.launch_plan(B, L1p + L2p + 2)
        assert 1 <= plan.warps <= tb.MAX_WARPS, (B, L1p, L2p)
        assert plan.buf % 16 == 0 and cols < plan.buf <= tb.STEP_BUF_MAX
        assert plan.smem == plan.warps * (plan.buf + rows * cols)
        assert plan.smem <= tb.SMEM_LIMIT, (B, L1p, L2p)
    # short walks keep all their steps in shared memory; the widest
    # launches of the paths spread over the SMs
    assert tb.launch_plan(8, 1024 + 1408 + 2).buf >= 1024 + 1408 + 2
    assert tb.launch_plan(8, 2434).warps == 1
    assert tb.launch_plan(1024, 770).warps * tb.SMS >= 1024


def test_pack_dec_is_unpack_decs_inverse():
    """gotoh_lanewise.pack_dec (the packer of the tests and the kernel
    checks) lays cells out as the kernel stores them: unpack_dec gives
    them back, and the rows padded to a multiple of 4 hold zeros."""
    dec = _random_decisions(5, 6, 22, 40)[0]
    packed = gotoh_lanewise.pack_dec(torch.from_numpy(dec))
    assert packed.shape == (6, 40 // 8, 24) and packed.dtype == torch.int32
    cells = gotoh_lanewise.unpack_dec(packed, 40).numpy()
    assert np.array_equal(cells[:, :22], dec)
    assert not cells[:, 22:].any()
