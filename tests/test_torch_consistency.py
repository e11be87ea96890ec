"""Default mode's pieces against kalign_tpu on the CPU: the consistency
table (anchors, every position map, the bonus arrays of every merge of a
pass), the map DPs' operands assembled from the token table, the bonus
added to the match, and whole buckets through the fused route and
through the materialised lanewise route with a bonus."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kalign_tpu.core import params as JP
from kalign_tpu.tpu import consistency as jcons
from kalign_tpu.tpu import engine as JTE
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.gpu import consistency as tcons
from kalign_tpu_torch.gpu import engine as TGE

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _jax_params(ap):
    return JP.AlnParam(**{**ap.__dict__})


@pytest.mark.parametrize("case", ["BB30014.tfa", "small.fa"])
def test_table_and_every_merge_bonus_match_kalign_tpu(case, monkeypatch):
    """The port's pipeline builds its table; kalign_tpu builds one from the
    same codes, parameters and distances (its CPU path, the XLA DP).
    Anchors and every position map must be identical, and so must the
    bonus arrays of every merge of the host-assembled progressive pass,
    which builds them on the host (the resident pass's votes are held
    against these in test_torch_resident.py)."""
    seen = {"merges": 0}
    build = tcons.ConsistencyTable.build.__func__

    def checked_build(cls, engine, codes, ap, seq_dist, K, weight):
        ct = build(cls, engine, codes, ap, seq_dist, K, weight)
        ref = jcons.ConsistencyTable.build(
            JTE.TpuEngine(use_pallas=False), codes, _jax_params(ap),
            seq_dist, K, weight)
        assert ct.anchor_ids == ref.anchor_ids
        assert ct.anchor_ids == jcons.select_anchors(seq_dist, K)
        assert ct.K == ref.K and ct.per_weight == ref.per_weight
        assert len(ct.pos_maps) == len(ref.pos_maps)
        for m, r in zip(ct.pos_maps, ref.pos_maps):
            assert m.dtype == r.dtype and np.array_equal(m, r)
        port_bonus = ct.bonus_arrays

        def bonus_arrays(*args):
            got = port_bonus(*args)
            want = ref.bonus_arrays(*args)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
            seen["merges"] += 1
            return got
        ct.bonus_arrays = bonus_arrays
        return ct

    monkeypatch.setattr(tcons.ConsistencyTable, "build",
                        classmethod(checked_build))
    m = tio.read_alignment(os.path.join(DATA, case))
    m.quiet = True
    out = TE.align_msa(m, consistency_anchors=5,
                       engine=TGE.GpuEngine("cpu", resident=False),
                       autoroute=False)
    assert seen["merges"] == out.numseq - 1


def test_leaf_operands_equal_leaf_assemble():
    """The map DPs' operands built from the token table: one-hot rows,
    substitution rows and masked penalties, bitwise (signed zeros
    included) against kalign_tpu's _leaf_assemble, pad problems too."""
    rng = np.random.default_rng(5)
    n, Lt, B, L1p, L2p = 30, 150, 16, 128, 256
    tok = rng.integers(0, 5, (n, Lt)).astype(np.uint8)
    ap = JP.aln_param_init(JP.BIOTYPE_DNA, 0)
    subm = np.asarray(ap.subm, np.float32)
    penv = np.array([-ap.gpo, -ap.gpe, -ap.tgpe], np.float32)
    rows = rng.integers(0, n, B).astype(np.int32)
    cols = rng.integers(0, n, B).astype(np.int32)
    la = rng.integers(1, Lt + 1, B).astype(np.int32)
    lb = rng.integers(1, Lt + 1, B).astype(np.int32)
    rows[-3:] = cols[-3:] = 0
    la[-3:] = lb[-3:] = 8
    t = torch.from_numpy
    got = TGE.leaf_operands(t(tok), t(subm), t(penv), t(rows), t(cols),
                            t(la), t(lb), L1p, L2p)
    want = JTE._leaf_assemble(jnp.asarray(tok), jnp.asarray(subm),
                              jnp.asarray(penv), jnp.asarray(rows),
                              jnp.asarray(cols), jnp.asarray(la),
                              jnp.asarray(lb), L1p=L1p, L2p=L2p)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32))


def _bonus_case(seed, B, L1p, L2p, K=5):
    rng = np.random.default_rng(seed)
    lhs = rng.integers(0, 3, (B, L1p, 23)).astype(np.float32)
    rhs = rng.integers(-40, 41, (B, L2p, 23)).astype(np.float32)
    la = rng.integers(1, L1p + 1, B).astype(np.int32)
    lb = rng.integers(1, L2p + 1, B).astype(np.int32)
    apr = rng.integers(-1, 12, (B, K, L1p)).astype(np.int32)
    apc = rng.integers(-1, 12, (B, K, L2p)).astype(np.int32)
    cfr = rng.random((B, K, L1p)).astype(np.float32)
    cfc = rng.random((B, K, L2p)).astype(np.float32)
    return lhs, rhs, la, lb, (np.float32(2.0 / K), apr, cfr, apc, cfc)


def _port_bonus_match(lhs, rhs, la, lb, eps, bonus):
    t = torch.from_numpy
    match = torch.bmm(t(lhs), t(rhs).transpose(1, 2))
    b = (torch.tensor(bonus[0]),) + tuple(t(a) for a in bonus[1:])
    return TGE.bonus_match(match, t(la), t(lb), t(eps), b).numpy()


@pytest.mark.parametrize("eps", [0.0, 2.0 ** -7])
def test_bonus_match_equals_prepare_match(eps):
    """Against _prepare_match jitted on the CPU.  XLA:CPU contracts its
    match - dev * eps into a fused multiply-add, so eps is a power of two
    here (the product is then exact and both roundings agree); the next
    test holds the non-dyadic 1e-3 against the form kalign_tpu's CPU
    engine uses."""
    lhs, rhs, la, lb, bonus = _bonus_case(1, 8, 24, 32)
    e = np.full(8, eps, np.float32)
    got = _port_bonus_match(lhs, rhs, la, lb, e, bonus)
    want, slope, eps_out = jax.jit(JTE._prepare_match)(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(e), (jnp.float32(bonus[0]),) + tuple(
            jnp.asarray(a) for a in bonus[1:]))
    assert np.array_equal(got.view(np.int32), np.asarray(want).view(np.int32))
    assert not np.any(np.asarray(slope)) and not np.any(np.asarray(eps_out))


def test_bonus_match_equals_the_cpu_engine_form():
    """kalign_tpu's CPU engine: host bias (_add_center_bias) and the
    densified bonus added to the match; bitwise on every problem's
    la x lb region at the progressive pass's eps = 1e-3."""
    B, L1p, L2p = 8, 24, 32
    lhs, rhs, la, lb, bonus = _bonus_case(2, B, L1p, L2p)
    e = np.full(B, 1e-3, np.float32)
    got = _port_bonus_match(lhs, rhs, la, lb, e, bonus)
    want = np.einsum("bic,bjc->bij", lhs, rhs).astype(np.float32)
    for k in range(B):
        JTE.TpuEngine._add_center_bias(want[k], int(la[k]), int(lb[k]),
                                       float(e[k]))
    want += JTE._densify_bonus(bonus, B, L1p, L2p)
    for k in range(B):
        assert np.array_equal(got[k, :la[k], :lb[k]].view(np.int32),
                              want[k, :la[k], :lb[k]].view(np.int32))


def _dna_bucket(seed, B, L):
    """Leaf DNA problems: one-hot counts against substitution rows of the
    DNA model, penalties of its size made dyadic (the prefix sums are
    then exact in any order)."""
    rng = np.random.default_rng(seed)
    subm = JP.aln_param_init(JP.BIOTYPE_DNA, 0).subm
    la = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lb = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lhs = np.zeros((B, L, 23), np.float32)
    rhs = np.zeros((B, L, 23), np.float32)
    for b in range(B):
        lhs[b, np.arange(la[b]), rng.integers(0, 5, la[b])] = 1.0
        rhs[b, :lb[b]] = subm[rng.integers(0, 5, lb[b])]
    penv = np.array([-217.0, -39.5, -292.5], np.float32)
    pc = np.zeros((B, 3, L + 1), np.float32)
    pr = np.zeros((B, 3, L + 1), np.float32)
    for b in range(B):
        pc[b, :, 1:lb[b] + 1] = penv[:, None]
        pr[b, :, 1:la[b] + 1] = penv[:, None]
    return lhs, rhs, pc, pr, la, lb


@pytest.mark.parametrize("with_bonus", [False, True])
def test_bucket_matches_the_jax_lanewise_routes(with_bonus, monkeypatch):
    """One 1,024 x 24 x 24 DNA bucket through the port's dispatch_bucket
    and collect_bucket on the CPU and through kalign_tpu's _run_bucket
    with its lanewise kernels in interpret mode, both at nc = 5: without
    a bonus both take the fused route, with one the materialised lanewise
    route.  Steps and scores bitwise."""
    B, L = 1024, 24
    lhs, rhs, pc, pr, la, lb = _dna_bucket(3, B, L)
    bonus = None
    eps = np.full(B, 1e-3, np.float32)
    if with_bonus:
        _, _, _, _, bonus = _bonus_case(4, B, L, L)
        # a power of two: XLA:CPU fuses the bias product into an FMA
        eps = np.full(B, 2.0 ** -7, np.float32)
    monkeypatch.setenv("KALIGN_TPU_LANEWISE", "interpret")
    jeng = JTE.TpuEngine(use_pallas=False)
    jeng.nc = 5
    want_steps, want_scores = jeng._run_bucket(lhs, rhs, pc, pr, la, lb, eps,
                                               bonus)
    teng = TGE.GpuEngine("cpu")
    teng.nc = 5
    got_steps, got_scores = teng.collect_bucket(teng.dispatch_bucket(
        lhs, rhs, pc, pr, la, lb, eps, bonus))
    route = teng.stats["batches"][-1]["route"]
    assert route == ("lanewise" if with_bonus else "fused")
    assert np.array_equal(got_scores.view(np.int64),
                          np.asarray(want_scores).view(np.int64))
    for g, w in zip(got_steps, want_steps):
        assert np.array_equal(np.asarray(g, np.int8), np.asarray(w, np.int8))
