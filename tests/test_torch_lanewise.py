"""The problem-per-lane Gotoh forward's plain version
(gpu/gotoh_lanewise.py, the arithmetic of csrc/gotoh_lanewise.cu) against
kalign_tpu's float-order oracle gotoh_forward_direct_np: bitwise scores,
end states and decisions."""

import numpy as np
import pytest
import torch

from kalign_tpu.tpu.gotoh_lanewise import gotoh_forward_direct_np
from kalign_tpu_torch.gpu import gotoh_lanewise
from kalign_tpu_torch.gpu.engine import GpuEngine


def _random_problem(seed, B, L1p, L2p, lb_min=0, integer=False,
                    dyadic=True):
    rng = np.random.default_rng(seed)
    if not dyadic:
        # arbitrary f32 penalties: the prefix sums then depend on their
        # order, which both sides take left to right in float32
        match = (rng.normal(size=(B, L1p, L2p)) * 3).astype(np.float32)
        pc = -np.abs(rng.normal(5.0, size=(B, 3, L2p + 1))).astype(np.float32)
        pr = -np.abs(rng.normal(5.0, size=(B, 3, L1p + 1))).astype(np.float32)
    elif integer:
        # small integer scores: exact ties everywhere
        match = rng.integers(-3, 4, size=(B, L1p, L2p)).astype(np.float32)
        pc = -rng.integers(1, 4, size=(B, 3, L2p + 1)).astype(np.float32)
        pr = -rng.integers(1, 4, size=(B, 3, L1p + 1)).astype(np.float32)
    else:
        match = (rng.normal(size=(B, L1p, L2p)) * 3).astype(np.float32)
        pc = (-rng.integers(16, 96, size=(B, 3, L2p + 1)) / 32).astype(
            np.float32)
        pr = (-rng.integers(16, 96, size=(B, 3, L1p + 1)) / 32).astype(
            np.float32)
    la = rng.integers(1, L1p + 1, size=B).astype(np.int32)
    lb = rng.integers(lb_min, L2p + 1, size=B).astype(np.int32)
    return match, pc, pr, la, lb


def _check(match, pc, pr, la, lb, slope=None, eps=None):
    t = torch.from_numpy
    kw = {} if slope is None else dict(slope=t(slope), bias_eps=t(eps))
    dec, score, st = gotoh_lanewise.forward(t(match), t(pc), t(pr), t(la),
                                            t(lb), **kw)
    dec_o, score_o, st_o = gotoh_forward_direct_np(match, pc, pr, la, lb,
                                                   slope, eps)
    assert np.array_equal(score.numpy().view(np.int32),
                          score_o.view(np.int32))
    assert np.array_equal(st.numpy(), st_o)
    du = gotoh_lanewise.unpack_dec(dec, match.shape[2]).numpy()
    for b in range(len(la)):
        if lb[b]:
            assert np.array_equal(du[b, :la[b], :lb[b]],
                                  dec_o[b, :la[b], :lb[b]]), b


@pytest.mark.parametrize("with_bias", [False, True])
def test_lanewise_plain_matches_oracle_bitwise(with_bias):
    match, pc, pr, la, lb = _random_problem(3, 96, 20, 16)
    if with_bias:
        slope = (lb / np.maximum(la, 1)).astype(np.float32)
        eps = np.full(len(la), 0.01, np.float32)
        _check(match, pc, pr, la, lb, slope, eps)
    else:
        _check(match, pc, pr, la, lb)


def test_lanewise_plain_non_dyadic_penalties():
    match, pc, pr, la, lb = _random_problem(9, 64, 20, 24, dyadic=False)
    _check(match, pc, pr, la, lb)


def test_lanewise_plain_tie_heavy_integer_matches():
    match, pc, pr, la, lb = _random_problem(5, 96, 24, 24, lb_min=1,
                                            integer=True)
    _check(match, pc, pr, la, lb)


def test_lanewise_plain_degenerate_lb0():
    match, pc, pr, la, lb = _random_problem(13, 32, 12, 8)
    lb[:] = 0
    _check(match, pc, pr, la, lb)


def test_lanewise_routing_rule():
    """Buckets whose power-of-two launch batch is k * 1024 take the
    problem-per-lane kernel where kalign_tpu's lanewise plan is feasible
    (kalign_tpu/tpu/engine.py:264-273)."""
    assert GpuEngine.lanewise_ok(1024, 384, 384)
    assert GpuEngine.lanewise_ok(4096, 256, 256)
    assert not GpuEngine.lanewise_ok(512, 256, 256)
    assert not GpuEngine.lanewise_ok(1536, 256, 256)
    # 1,024 problems but no feasible plan: the row kernel, as in JAX
    assert not GpuEngine.lanewise_ok(1024, 256, 1024)
    assert not GpuEngine.lanewise_ok(1024, 128, 2048)
