"""Match preparation (kalign_tpu_torch/gpu/prepare.py) on the CPU: its
plain version over blocks of rows and bands of columns (row0 / col0, the
anchor vectors cut to the block) against the whole match, against
kalign_tpu's _prepare_match and against the form kalign_tpu's CPU engine
uses (_add_center_bias + _densify_bonus), and the wrapper's routing.

Tolerance: bitwise (float32 bits) everywhere; against _prepare_match jitted
on the CPU with a dyadic eps (XLA:CPU contracts match - dev * eps into a
fused multiply-add, so the product must be exact for both roundings to
agree), against the CPU engine's form on each problem's la x lb region
(it biases only there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalign_tpu.tpu import engine as JTE
from kalign_tpu_torch.gpu import engine as TGE
from kalign_tpu_torch.gpu import prepare as P


def _case(seed, B, L1p, L2p, K=5, dead_rows=0):
    """A batch's operands and compact bonus; dead_rows rows of every
    anchor at -1 (no anchor there)."""
    rng = np.random.default_rng(seed)
    lhs = rng.integers(0, 3, (B, L1p, 23)).astype(np.float32)
    rhs = rng.integers(-40, 41, (B, L2p, 23)).astype(np.float32)
    la = rng.integers(1, L1p + 1, B).astype(np.int32)
    lb = rng.integers(1, L2p + 1, B).astype(np.int32)
    apr = rng.integers(-1, 12, (B, K, L1p)).astype(np.int32)
    apc = rng.integers(-1, 12, (B, K, L2p)).astype(np.int32)
    apr[:, :, :dead_rows] = -1
    cfr = rng.random((B, K, L1p)).astype(np.float32)
    cfc = rng.random((B, K, L2p)).astype(np.float32)
    return lhs, rhs, la, lb, (np.float32(2.0 / max(K, 1)), apr, cfr, apc, cfc)


def _tensors(lhs, rhs, la, lb, bonus):
    t = torch.from_numpy
    match = torch.bmm(t(lhs), t(rhs).transpose(1, 2))
    b = (torch.tensor(bonus[0]),) + tuple(t(a) for a in bonus[1:])
    return match, t(la), t(lb), b


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("rows, cols", [(8, 32), (5, 12), (24, 16),
                                        (1, 40), (24, 40)])
@pytest.mark.parametrize("K, dead", [(5, 0), (5, 7), (1, 0), (0, 0)])
def test_blocks_give_the_whole_match(rows, cols, K, dead):
    """Every block of ``rows`` x ``cols`` (the ragged last ones among
    them), prepared at its row0 / col0 with its cut of the anchor
    vectors, holds the bits of the same cells of the whole match
    prepared at once; K = 5, 1 and 0 anchors, anchors at -1 on the first
    rows."""
    B, L1p, L2p = 4, 24, 40
    lhs, rhs, la, lb, bonus = _case(7 * K + rows + cols, B, L1p, L2p, K,
                                    dead)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    eps = torch.full((B,), 1e-3)
    whole = P.bonus_match(match, la_t, lb_t, eps, b)
    for r0 in range(0, L1p, rows):
        for c0 in range(0, L2p, cols):
            r1, c1 = min(r0 + rows, L1p), min(c0 + cols, L2p)
            got = P.prepare_match(match[:, r0:r1, c0:c1].contiguous(), la_t,
                                  lb_t, eps, P.cut(b, r0, r1, c0, c1),
                                  col0=c0, row0=r0)
            assert np.array_equal(_bits(got),
                                  _bits(whole[:, r0:r1, c0:c1])), (r0, c0)


def test_engine_bonus_match_is_the_plain_version():
    """gpu/engine.py keeps bonus_match importable, and bucket_match adds
    bias and bonus through prepare_match: the same bits, the DP's bias
    zeroed."""
    lhs, rhs, la, lb, bonus = _case(3, 4, 16, 24)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    eps = torch.full((4,), 1e-3)
    assert TGE.bonus_match is P.bonus_match
    got, slope, eps_out = TGE.bucket_match(torch.from_numpy(lhs),
                                           torch.from_numpy(rhs), la_t,
                                           lb_t, eps, b)
    want = P.bonus_match(match, la_t, lb_t, eps, b)
    assert np.array_equal(_bits(got), _bits(want))
    assert not slope.any() and not eps_out.any()


@pytest.mark.parametrize("eps", [0.0, 2.0 ** -7])
def test_row_blocks_match_kalign_tpu_prepare_match(eps):
    """Row blocks of 10 rows at their row0 against kalign_tpu's
    _prepare_match on the whole batch, jitted on the CPU (dyadic eps)."""
    B, L1p, L2p = 8, 24, 32
    lhs, rhs, la, lb, bonus = _case(11, B, L1p, L2p)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    e = np.full(B, eps, np.float32)
    want, _, _ = jax.jit(JTE._prepare_match)(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(e), (jnp.float32(bonus[0]),) + tuple(
            jnp.asarray(a) for a in bonus[1:]))
    want = np.asarray(want)
    for r0 in range(0, L1p, 10):
        r1 = min(r0 + 10, L1p)
        got = P.prepare_match(match[:, r0:r1].contiguous(), la_t, lb_t,
                              torch.from_numpy(e), P.cut(b, r0, r1),
                              row0=r0)
        assert np.array_equal(_bits(got), _bits(want[:, r0:r1]))


def test_bands_match_the_cpu_engine_form():
    """Bands of 12 columns at their col0, rows in blocks of 7, against
    kalign_tpu's CPU engine: _add_center_bias on the host and the
    densified bonus added, at the progressive pass's eps = 1e-3, bitwise
    on every problem's la x lb region."""
    B, L1p, L2p = 8, 24, 36
    lhs, rhs, la, lb, bonus = _case(13, B, L1p, L2p)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    e = np.full(B, 1e-3, np.float32)
    want = np.einsum("bic,bjc->bij", lhs, rhs).astype(np.float32)
    for k in range(B):
        JTE.TpuEngine._add_center_bias(want[k], int(la[k]), int(lb[k]),
                                       float(e[k]))
    want += JTE._densify_bonus(bonus, B, L1p, L2p)
    got = np.zeros_like(want)
    for r0 in range(0, L1p, 7):
        for c0 in range(0, L2p, 12):
            r1, c1 = min(r0 + 7, L1p), min(c0 + 12, L2p)
            got[:, r0:r1, c0:c1] = P.prepare_match(
                match[:, r0:r1, c0:c1].contiguous(), la_t, lb_t,
                torch.from_numpy(e), P.cut(b, r0, r1, c0, c1), col0=c0,
                row0=r0).numpy()
    for k in range(B):
        assert np.array_equal(_bits(got[k, :la[k], :lb[k]]),
                              _bits(want[k, :la[k], :lb[k]])), k


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """A CPU block takes the plain version (a new tensor, no launch); a
    device that is neither raises."""
    lhs, rhs, la, lb, bonus = _case(17, 2, 8, 16)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    eps = torch.full((2,), 1e-3)
    before = P.launches
    got = P.prepare_match(match, la_t, lb_t, eps, b)
    assert got is not match and P.launches == before
    assert np.array_equal(_bits(got),
                          _bits(P.bonus_match(match, la_t, lb_t, eps, b)))
    with pytest.raises(ValueError, match="unsupported device"):
        P.prepare_match(match.to("meta"), la_t, lb_t, eps, b)


@pytest.mark.parametrize("B, R, W, tx, rows", [
    (1, 3440, 156032, 256, 64),     # a plastome root-merge block
    (8, 9856, 9728, 256, 64),       # long_default's largest merge launch
    (8, 384, 384, 128, 16),         # a serve-path launch: rows cut down
    (512, 384, 384, 128, 64),       # the protein paths' largest
    (1, 64, 131072, 256, 16),       # few rows, one problem
    (2, 5, 8, 32, 16),              # narrower than a warp's float4s
    (3, 17, 2052, 256, 16)])        # W past a tile, not a multiple
def test_launch_plan_by_shape(B, R, W, tx, rows):
    """prepare.launch_plan: tx threads across (the least power of two
    from 32 covering W's float4s, at most 256), rows a tile halved from
    64 while the grid has fewer than FILL_BLOCKS blocks, never below
    MIN_ROWS or the tile's threads down; the tiles cover the block."""
    plan = P.launch_plan(B, R, W)
    assert (plan.tx, plan.rows) == (tx, rows)
    assert plan.ctiles * plan.tx * P.COLS >= W > \
        (plan.ctiles - 1) * plan.tx * P.COLS
    assert plan.rtiles * plan.rows >= R > (plan.rtiles - 1) * plan.rows
    least = max(P.THREADS // plan.tx, P.MIN_ROWS)
    assert plan.rows >= least
    assert plan.rows == least or plan.rows == P.MAX_ROWS or \
        B * plan.ctiles * plan.rtiles >= P.FILL_BLOCKS


def _kernel_model(match, la, lb, eps, bonus, col0, row0):
    """csrc/prepare_match.cu's schedule in PyTorch: the launch plan's
    tiles one by one (each cell once), per tile the bias, then the
    anchors in groups of 8 in k order into an accumulator from +0, added
    once."""
    B, R, W = match.shape
    plan = P.launch_plan(B, R, W)
    per_w, apr, cfr, apc, cfc = bonus
    K = apr.shape[1]
    slope = lb.float() / torch.clamp(la.float(), min=1.0)
    out = torch.full_like(match, float("nan"))
    hits = torch.zeros(match.shape, dtype=torch.int32)
    zero = torch.zeros(())
    for b in range(B):
        for rt in range(plan.rtiles):
            r = slice(rt * plan.rows, min((rt + 1) * plan.rows, R))
            t = (torch.arange(row0 + r.start + 1, row0 + r.stop + 1)
                 .float() * slope[b])[:, None]
            for ct in range(plan.ctiles):
                c = slice(ct * plan.tx * P.COLS,
                          min((ct + 1) * plan.tx * P.COLS, W))
                jj = torch.arange(col0 + c.start + 1,
                                  col0 + c.stop + 1).float()[None]
                m = match[b, r, c] - torch.abs(jj - t) * eps[b]
                acc = torch.zeros_like(m)
                for k0 in range(0, K, 8):
                    for k in range(k0, min(k0 + 8, K)):
                        ar = apr[b, k, r][:, None]
                        live = (ar >= 0) & (apc[b, k, c][None] == ar)
                        w = (per_w * cfr[b, k, r])[:, None]
                        acc = acc + torch.where(live, w * cfc[b, k, c][None],
                                                zero)
                out[b, r, c] = m + acc
                hits[b, r, c] += 1
    assert torch.all(hits == 1)
    return out


@pytest.mark.parametrize("K", [0, 1, 5, 9, 16])
@pytest.mark.parametrize("B, R, W, row0, col0, dead", [
    (1, 70, 1028, 100, 384, 7),     # W a tile and one float4
    (8, 5, 8, 11, 13, 0),           # tiles of 32 threads across
    (3, 17, 384, 0, 0, 17)])        # every row's anchors at -1
def test_kernel_schedule_is_bonus_match(K, B, R, W, row0, col0, dead):
    """The kernel's schedule (its tiles, the anchors in groups of 8 past
    K = 8) gives bonus_match's bits at K = 0, 1, 5, 9 and 16, with row0 /
    col0 offsets and a W tail that is not a tile multiple."""
    lhs, rhs, la, lb, bonus = _case(31 * K + R, B, R, W, K, dead)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    eps = torch.full((B,), 1e-3)
    want = P.bonus_match(match, la_t, lb_t, eps, b, col0, row0)
    got = _kernel_model(match, la_t, lb_t, eps, b, col0, row0)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("K", [9, 16])
def test_anchor_groups_match_kalign_tpu_prepare_match(K):
    """Past 8 anchors the kernel's schedule against kalign_tpu's
    _prepare_match jitted on the CPU (dyadic eps), bitwise."""
    B, L1p, L2p = 4, 24, 40
    lhs, rhs, la, lb, bonus = _case(K, B, L1p, L2p, K)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    e = np.full(B, 2.0 ** -7, np.float32)
    want, _, _ = jax.jit(JTE._prepare_match)(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(e), (jnp.float32(bonus[0]),) + tuple(
            jnp.asarray(a) for a in bonus[1:]))
    got = _kernel_model(match, la_t, lb_t, torch.from_numpy(e), b, 0, 0)
    assert np.array_equal(_bits(got), _bits(np.asarray(want)))


def test_wrapper_refusals():
    """The kernel's wrapper refuses, before any launch, a block that is not
    contiguous float32, whose W is not a multiple of 4, whose data is not
    16-byte aligned, or whose anchor vectors are not the block's."""
    lhs, rhs, la, lb, bonus = _case(19, 2, 8, 16)
    match, la_t, lb_t, b = _tensors(lhs, rhs, la, lb, bonus)
    eps = torch.full((2,), 1e-3)
    before = P.launches
    with pytest.raises(ValueError, match="contiguous float32"):
        P.launch(match.double(), la_t, lb_t, eps, b)
    with pytest.raises(ValueError, match="contiguous float32"):
        P.launch(match.transpose(1, 2), la_t, lb_t, eps, b)
    odd = match[:, :, :14].contiguous()
    with pytest.raises(ValueError, match="whole float4s"):
        P.launch(odd, la_t, lb_t, eps, P.cut(b, 0, 8, 0, 14))
    flat = torch.zeros(match.numel() + 1)
    shifted = flat[1:].view(match.shape)
    with pytest.raises(ValueError, match="whole float4s"):
        P.launch(shifted, la_t, lb_t, eps, b)
    with pytest.raises(ValueError, match="not the block's"):
        P.launch(match, la_t, lb_t, eps, P.cut(b, 0, 7))
    with pytest.raises(ValueError, match="not the block's"):
        P.launch(match, la_t, lb_t, eps, P.cut(b, 0, 8, 0, 12))
    assert P.launches == before
