"""The port's Gotoh DP (plain PyTorch) against kalign_tpu's: the
single-problem scan DP (tpu/gotoh.py), and the row kernel's plain version
(gpu/gotoh_row.py, the arithmetic of csrc/gotoh_row.cu) against the XLA
oracle and the Pallas row kernel run in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kalign_tpu.tpu import gotoh as jgotoh
from kalign_tpu.tpu.gotoh_pallas import gotoh_forward_pallas
from kalign_tpu_torch.gpu import gotoh as tgotoh
from kalign_tpu_torch.gpu import gotoh_row
from kalign_tpu_torch.gpu import traceback as tb


def _random_problem(rng, B, L1p, L2p):
    """tests/test_pallas_kernel.py's problems: random f32 penalties with
    per-column variation, ragged lengths."""
    match = rng.normal(scale=3.0, size=(B, L1p, L2p)).astype(np.float32)
    pc = -np.abs(rng.normal(loc=5.0, size=(B, 3, L2p + 1))).astype(np.float32)
    pr = -np.abs(rng.normal(loc=5.0, size=(B, 3, L1p + 1))).astype(np.float32)
    pc[:, 1] *= 0.2
    pr[:, 1] *= 0.2
    la = rng.integers(1, L1p + 1, size=B).astype(np.int32)
    lb = rng.integers(1, L2p + 1, size=B).astype(np.int32)
    return match, pc, pr, la, lb


def _dyadic_problem(rng, B, L1p, L2p):
    """Penalties k/32: every prefix sum is exact in any order."""
    match = (rng.normal(size=(B, L1p, L2p)) * 3).astype(np.float32)
    pc = (-rng.integers(16, 96, size=(B, 3, L2p + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, size=(B, 3, L1p + 1)) / 32).astype(np.float32)
    la = rng.integers(1, L1p + 1, size=B).astype(np.int32)
    lb = rng.integers(1, L2p + 1, size=B).astype(np.int32)
    return match, pc, pr, la, lb


def _xla(match, pc, pr, la, lb, k):
    return jgotoh.gotoh_forward(
        jnp.asarray(match[k]), jnp.asarray(pc[k, 0]), jnp.asarray(pc[k, 1]),
        jnp.asarray(pc[k, 2]), jnp.asarray(pr[k, 0]), jnp.asarray(pr[k, 1]),
        jnp.asarray(pr[k, 2]), int(la[k]), int(lb[k]))


def _row_port(match, pc, pr, la, lb, slope=None, eps=None):
    t = torch.from_numpy
    kw = {}
    if slope is not None:
        kw = dict(slope=t(slope), bias_eps=t(eps))
    dec, score, st = gotoh_row.forward(t(match), t(pc), t(pr), t(la), t(lb),
                                       **kw)
    L1p, L2p = match.shape[1:]
    steps, n = tb.walk_rows(dec, t(la), t(lb), st, L1p + L2p + 2)
    return dec.numpy(), score.numpy(), st.numpy(), steps.numpy(), n.numpy()


def test_single_problem_dp_matches_xla():
    rng = np.random.default_rng(1)
    match, pc, pr, la, lb = _random_problem(rng, 4, 24, 40)
    for k in range(4):
        dec_j, score_j, st_j = _xla(match, pc, pr, la, lb, k)
        dec_t, score_t, st_t = tgotoh.gotoh_forward(
            match[k], pc[k, 0], pc[k, 1], pc[k, 2], pr[k, 0], pr[k, 1],
            pr[k, 2], int(la[k]), int(lb[k]))
        assert score_t == pytest.approx(float(score_j), rel=1e-5)
        assert st_t == int(st_j)
        assert tgotoh.traceback(dec_t, int(la[k]), int(lb[k]), st_t) == \
            jgotoh.traceback(np.asarray(dec_j), int(la[k]), int(lb[k]),
                             int(st_j))
    path = tgotoh.steps_to_kalign_path([1, 0, 0, 2], 3, 3)
    assert path.tolist() == [4, 33, 0, 0, 34, 3]


@pytest.mark.parametrize("shape", [(8, 128, 128), (8, 128, 256),
                                   (16, 256, 128), (2, 64, 8192)])
def test_row_plain_matches_xla_scores_and_paths(shape):
    """tests/test_pallas_kernel.py:52 for the port: scores within rel
    1e-5 and identical paths; 8,192 columns are a width of the cluster
    kernel, which kalign_tpu gives its XLA scan."""
    B, L1p, L2p = shape
    rng = np.random.default_rng(sum(shape))
    match, pc, pr, la, lb = _random_problem(rng, B, L1p, L2p)
    _, score, _, steps, n = _row_port(match, pc, pr, la, lb)
    for k in range(B):
        dec_j, score_j, st_j = _xla(match, pc, pr, la, lb, k)
        path = jgotoh.traceback(np.asarray(dec_j), int(la[k]), int(lb[k]),
                                int(st_j))
        assert score[k] == pytest.approx(float(score_j), rel=1e-5), k
        assert steps[k, :n[k]].tolist() == path, k


def test_row_plain_bitwise_with_dyadic_penalties():
    rng = np.random.default_rng(7)
    B, L1p, L2p = 6, 128, 128
    match, pc, pr, la, lb = _dyadic_problem(rng, B, L1p, L2p)
    dec, score, st, _, _ = _row_port(match, pc, pr, la, lb)
    for k in range(B):
        dec_j, score_j, st_j = _xla(match, pc, pr, la, lb, k)
        assert score[k].view(np.int32) == np.float32(score_j).view(np.int32)
        assert st[k] == int(st_j)
        dj = np.asarray(dec_j)[1:la[k] + 1, 1:lb[k] + 1]
        assert np.array_equal(dec[k, :la[k], :lb[k]], dj), k


def test_row_plain_matches_pallas_interpret_with_bias():
    """Bitwise against the TPU kernel itself (interpret mode) with the
    fused centering bias on, la = 0 and lb = 0 problems included."""
    rng = np.random.default_rng(11)
    B, L1p, L2p = 8, 128, 128
    match, pc, pr, la, lb = _dyadic_problem(rng, B, L1p, L2p)
    la[0] = 0
    lb[1] = 0
    la[2] = lb[2] = 0
    slope = (lb / np.maximum(la, 1)).astype(np.float32)
    eps = np.full(B, 1e-3, np.float32)
    dec_p, score_p, st_p = gotoh_forward_pallas(
        jnp.asarray(match), jnp.asarray(pc), jnp.asarray(pr),
        jnp.asarray(la), jnp.asarray(lb), bt=8, interpret=True,
        slope=jnp.asarray(slope), bias_eps=jnp.asarray(eps))
    dec, score, st, steps, n = _row_port(match, pc, pr, la, lb, slope, eps)
    assert np.array_equal(score.view(np.int32),
                          np.asarray(score_p).view(np.int32))
    assert np.array_equal(st, np.asarray(st_p))
    dec_p = np.asarray(dec_p)
    for k in range(B):
        assert np.array_equal(dec[k, :la[k], :lb[k]],
                              dec_p[k, :la[k], :lb[k]]), k
    # degenerate walks: all-GA for la == 0, all-GB for lb == 0, none for both
    assert n[0] == lb[0] and (steps[0, :n[0]] == 1).all()
    assert n[1] == la[1] and (steps[1, :n[1]] == 2).all()
    assert n[2] == 0


def test_prefix_sums_run_left_to_right_in_float32():
    """The scan transform's prefix sums on the CPU: numpy's sequential
    float32 order, on strided views as prepare takes them, and the
    kernel's wrapper refuses a CPU tensor."""
    from kalign_tpu_torch.gpu import scan
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 3, 40), dtype=np.float32))
    for v in (x[:, 1, 1:], x[:, 2, :1], x[0:1, 0, :]):
        got = scan.prefix_sum_f32(v).numpy()
        ref = np.zeros(v.shape, np.float32)
        for r in range(v.shape[0]):
            s = np.float32(0.0)
            for j in range(v.shape[1]):
                s = np.float32(s + v[r, j].item())
                ref[r, j] = s
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        scan.launch(x[:, 0, :])


@pytest.mark.parametrize("B", [1, 512])
def test_row_launch_config_covers_every_width_of_the_old_kernel(B):
    """launch_config gives every L2p the one-block-of-128-threads design
    took (33 bytes of shared memory per column, so up to 7,040) a block
    within Hopper's limits: whole warps, enough columns, at most the
    instantiation's threads and 232,448 bytes of shared memory, sized by
    the kernel's own formula; every wider L2p (7,296 to 32,768) gets the
    cluster instantiation, whose bands (whole warps of at most 896 threads,
    at most 16 bands) cover the row; an L2p that is no multiple of 128
    raises."""
    old_max = (gotoh_row.SMEM_LIMIT - 16) // 33 // 128 * 128
    assert old_max == 7040
    for L2p in range(128, old_max + 1, 128):
        cfg = gotoh_row.launch_config(B, L2p)
        max_threads, stages = gotoh_row.CHUNKS[cfg.ch]
        assert cfg.route == "row" and cfg.blocks == 1
        assert cfg.threads % 32 == 0 and cfg.threads <= max_threads
        assert L2p <= cfg.threads * cfg.ch < L2p + 32 * cfg.ch
        assert cfg.ch == (4 if L2p <= 4 * 512 else 8)
        assert cfg.smem == 4 * ((4 + stages) * cfg.threads * cfg.ch
                                + cfg.threads // 32 * 2 * 5)
        assert cfg.smem <= gotoh_row.SMEM_LIMIT == 232448
    assert gotoh_row.launch_config(B, 7168).route == "row"
    for L2p in range(7296, 32768 + 1, 128):
        cfg = gotoh_row.launch_config(B, L2p)
        assert cfg.route == "cluster"
        assert cfg.threads % 32 == 0
        assert cfg.threads <= gotoh_row.CHUNKS[cfg.ch][0]
        assert cfg.band == cfg.threads * cfg.ch
        assert 2 <= cfg.blocks <= 16
        assert L2p <= cfg.blocks * cfg.band < L2p + cfg.blocks * 32 * 8
        assert cfg.smem <= gotoh_row.SMEM_LIMIT
    for bad in (64, 200):
        with pytest.raises(ValueError, match="row Gotoh kernel"):
            gotoh_row.launch_config(B, bad)
