"""The fused-match Gotoh forward's plain version (gpu/gotoh_fused.py, the
arithmetic of the FusedOperands instantiation of csrc/gotoh_lanewise.cu)
against kalign_tpu's oracle gotoh_forward_direct_np(operands=) and its
Pallas kernel gotoh_forward_fused in interpret mode, bitwise; and the
port's routing rules (live alphabet, lanewise and fused feasibility)
against the JAX engine's.

Test data is dyadic, as in tests/test_gotoh_fused.py: every product and
partial sum of the match chain is exact, so any compilation of the
Pallas kernel rounds as the oracle does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kalign_tpu.core import params as JP
from kalign_tpu.tpu import gotoh_lanewise as jlw
from kalign_tpu.tpu.engine import TpuEngine
from kalign_tpu_torch.core import params as TP
from kalign_tpu_torch.gpu import gotoh_fused, gotoh_lanewise
from kalign_tpu_torch.gpu.engine import GpuEngine


def _dyadic_case(seed, B, L1p, L2p, nc, shrink=1.0):
    rng = np.random.default_rng(seed)
    lhs = (rng.integers(-32, 33, (B, L1p, nc)) * 0.25 * shrink).astype(
        np.float32)
    rhs = (rng.integers(-32, 33, (B, L2p, nc)) * 0.25 * shrink).astype(
        np.float32)
    pc = (rng.integers(-16, 0, (B, 3, L2p + 1)) * 0.5).astype(np.float32)
    pr = (rng.integers(-16, 0, (B, 3, L1p + 1)) * 0.5).astype(np.float32)
    la = rng.integers(max(2, L1p // 2), L1p + 1, B).astype(np.int32)
    lb = rng.integers(max(2, L2p // 2), L2p + 1, B).astype(np.int32)
    slope = (lb / np.maximum(la, 1)).astype(np.float32)
    eps = (rng.integers(0, 5, B) * 0.125).astype(np.float32)
    return lhs, rhs, pc, pr, la, lb, slope, eps


def _port(lhs, rhs, pc, pr, la, lb, slope, eps):
    t = torch.from_numpy
    return gotoh_fused.forward(t(lhs), t(rhs), t(pc), t(pr), t(la), t(lb),
                               t(slope), t(eps))


def _same_bits(a, b):
    return np.array_equal(np.asarray(a).view(np.int32),
                          np.asarray(b).view(np.int32))


@pytest.mark.parametrize("nc,B,L1p,L2p,shrink,degenerate", [
    (5, 64, 20, 24, 1.0, False),
    (23, 48, 16, 16, 0.25, False),
    (5, 70, 16, 16, 1.0, True),
])
def test_fused_plain_matches_oracle_bitwise(nc, B, L1p, L2p, shrink,
                                            degenerate):
    """nc = 5 (DNA), nc = 23 with magnitudes shrunk so the long chain stays
    exact, and lb = 0 / short rows; centering bias on.  (The oracle has
    no la = 0 convention; the kernels' is held in the interpret test.)"""
    lhs, rhs, pc, pr, la, lb, slope, eps = _dyadic_case(
        7 + nc, B, L1p, L2p, nc, shrink)
    if degenerate:
        lb[::7] = 0
        la[::5] = 2
        slope = (lb / np.maximum(la, 1)).astype(np.float32)
    dec, score, st = _port(lhs, rhs, pc, pr, la, lb, slope, eps)
    dec_o, score_o, st_o = jlw.gotoh_forward_direct_np(
        None, pc, pr, la, lb, slope=slope, bias_eps=eps,
        operands=(lhs, rhs))
    assert _same_bits(score.numpy(), score_o)
    assert np.array_equal(st.numpy(), st_o)
    du = gotoh_lanewise.unpack_dec(dec, L2p).numpy()
    for b in range(B):
        if la[b] and lb[b]:
            assert np.array_equal(du[b, :la[b], :lb[b]],
                                  dec_o[b, :la[b], :lb[b]]), b


def test_fused_plain_matches_pallas_interpret_bitwise():
    """One case against the Pallas kernel itself (interpret mode is
    slow): 1,024 problems at 24 x 32, plan (4, 16), with la = 0, lb = 0
    and both."""
    lhs, rhs, pc, pr, la, lb, slope, eps = _dyadic_case(7, jlw.BT, 24, 32, 5)
    la[[3, 5]] = 0
    lb[[4, 5]] = 0
    slope = (lb / np.maximum(la, 1)).astype(np.float32)
    dec, score, st = _port(lhs, rhs, pc, pr, la, lb, slope, eps)
    dec_j, score_j, st_j = jlw.gotoh_forward_fused(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(pc),
        jnp.asarray(pr), jnp.asarray(la), jnp.asarray(lb), interpret=True,
        slope=jnp.asarray(slope), bias_eps=jnp.asarray(eps), plan=(4, 16))
    assert _same_bits(score.numpy(), np.asarray(score_j))
    assert np.array_equal(st.numpy(), np.asarray(st_j))
    du = gotoh_lanewise.unpack_dec(dec, 32).numpy()
    dj = jlw.unpack_dec_lanewise(np.asarray(dec_j), 32)
    for b in range(jlw.BT):
        assert np.array_equal(du[b, :la[b], :lb[b]], dj[b, :la[b], :lb[b]])


def test_fused_plain_equals_lanewise_plain_on_the_chain_match():
    """On any data (not only dyadic) the fused route is the lanewise DP of
    the chain-built match."""
    rng = np.random.default_rng(4)
    B, L1p, L2p, nc = 40, 16, 24, 5
    lhs = torch.from_numpy(rng.normal(size=(B, L1p, nc)).astype(np.float32))
    rhs = torch.from_numpy(rng.normal(size=(B, L2p, nc)).astype(np.float32))
    pc = torch.from_numpy(-np.abs(rng.normal(5.0, size=(B, 3, L2p + 1)))
                          .astype(np.float32))
    pr = torch.from_numpy(-np.abs(rng.normal(5.0, size=(B, 3, L1p + 1)))
                          .astype(np.float32))
    la = torch.from_numpy(rng.integers(0, L1p + 1, B).astype(np.int32))
    lb = torch.from_numpy(rng.integers(0, L2p + 1, B).astype(np.int32))
    slope = lb.float() / torch.clamp(la.float(), min=1.0)
    eps = torch.full((B,), 1e-3)
    got = gotoh_fused.forward(lhs, rhs, pc, pr, la, lb, slope, eps)
    ref = gotoh_lanewise.forward(gotoh_fused.chain_match(lhs, rhs), pc, pr,
                                 la, lb, slope, eps)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_live_nc_matches_the_jax_engine():
    jeng = TpuEngine(use_pallas=False)
    dna_t = TP.aln_param_init(TP.BIOTYPE_DNA, 0)
    dna_j = JP.aln_param_init(JP.BIOTYPE_DNA, 0)
    prot_t = TP.aln_param_init(TP.BIOTYPE_PROTEIN, 0)
    prot_j = JP.aln_param_init(JP.BIOTYPE_PROTEIN, 0)
    cases = [(dna_t, dna_j, 4), (dna_t, dna_j, 3), (dna_t, dna_j, 7),
             (prot_t, prot_j, 22), (prot_t, prot_j, 4)]
    for ap_t, ap_j, max_code in cases:
        assert GpuEngine.live_nc(ap_t.subm, max_code) == \
            jeng._live_nc(ap_j.subm, max_code), max_code
    assert GpuEngine.live_nc(dna_t.subm, 4) == 5
    stray = np.array(dna_t.subm)
    stray[6, 2] = 1.0
    assert GpuEngine.live_nc(stray, 4) == jeng._live_nc(stray, 4) == 0


def test_routing_rules_match_the_jax_feasibility():
    """lanewise_ok / fused_ok equal lanewise_feasible / fused_feasible
    over widths 128..2048 (the rules behind near-tie parity)."""
    widths = range(128, 2049, 128)
    seen = {True: 0, False: 0}
    for B in (512, 1024, 2048, 3072):
        for L1p in widths:
            for L2p in widths:
                lw = GpuEngine.lanewise_ok(B, L1p, L2p)
                assert lw == jlw.lanewise_feasible(B, L1p, L2p), \
                    (B, L1p, L2p)
                seen[lw] += 1
                for nc in (5, 23):
                    assert GpuEngine.fused_ok(B, L1p, L2p, nc) == \
                        jlw.fused_feasible(B, L1p, L2p, nc), \
                        (B, L1p, L2p, nc)
    assert seen[True] and seen[False]
    assert GpuEngine.fused_ok(1024, 384, 384, 5)
    assert not GpuEngine.fused_ok(1024, 384, 512, 5)
    assert not GpuEngine.fused_ok(1024, 256, 256, 0)


@pytest.mark.parametrize("nc", [0, 1, 5, 8, 23, 32])
def test_lanewise_launch_plan_fits_shared_memory(nc):
    """gotoh_lanewise.launch_plan (the block of csrc/gotoh_lanewise.cu:
    staged column records and the strip boundary row per warp) fits one
    block at every width the engine routes to the kernel: the match
    stream (nc = 0) at lanewise_ok's widths, the fused route at
    fused_ok's, for every operand width the kernel takes (the plan
    depends on L2p alone; the rules on L1p only through its divisors)."""
    widths = [(B, L1p, L2p) for B in (1024, 2048, 4096)
              for L1p in (8, 24, 128, 136, 2048)
              for L2p in range(8, 2049, 8)
              if (GpuEngine.lanewise_ok(B, L1p, L2p) if nc == 0
                  else jlw.fused_feasible(B, L1p, L2p, nc))]
    assert widths
    if nc == 5:
        assert {w for w in widths if GpuEngine.fused_ok(*w, nc)} == \
            set(widths)
    for _, _, L2p in widths:
        plan = gotoh_lanewise.launch_plan(L2p, nc)
        assert 1 <= plan.warps <= gotoh_lanewise.MAX_WARPS
        assert plan.smem == gotoh_lanewise.smem_bytes(L2p, nc, plan.warps)
        assert plan.smem <= 232448, (L2p, nc)
    # the default path's launch shapes keep four problems per block
    assert gotoh_lanewise.launch_plan(384, 5).warps == 4
