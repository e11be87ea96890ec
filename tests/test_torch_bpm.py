"""The bit-parallel edit distance's plain version (gpu/bpm.py, the
function of csrc/bpm.cu) and the anchor-distance stage (gpu/distances.py)
against kalign_tpu: tpu/bpm.py::bpm_batch (XLA) and the native
kt_dist_to_anchors / kt_bpm_block, bit-exact; the per-sequence
match-mask table against the per-pair masks, the table kernel's warp
schedule (bit planes by ballot) against both, and the kernel's launch
plan."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kalign_tpu import native as jnative
from kalign_tpu.tpu import bpm as jbpm
from kalign_tpu_torch.gpu import bpm, distances


def _tokens(lens, seed):
    rng = np.random.default_rng(seed)
    tok = np.zeros((len(lens), int(max(lens))), np.uint8)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.integers(0, 13, size=n)
    return tok


def test_plain_bpm_matches_xla_bpm_batch():
    """Patterns of 1, 2 and 16 blocks (m = 1024), texts longer than the
    pattern and texts past 1024 symbols."""
    lens = np.array([1, 40, 64, 65, 130, 300, 1024, 1100], np.int32)
    tok = _tokens(lens, 0)
    pairs = [(7, 6), (6, 7), (5, 4), (4, 3), (3, 2), (2, 1), (7, 0), (6, 5),
             (1, 1), (0, 2)]
    ti = np.array([a for a, _ in pairs], np.int32)
    pi = np.array([b for _, b in pairs], np.int32)
    n = lens[ti]
    m = np.minimum(lens[pi], 1024).astype(np.int32)
    pats = np.zeros((len(pairs), 1024), np.uint8)
    for k, p in enumerate(pi):
        pats[k, :m[k]] = tok[p, :m[k]]
    texts = tok[ti]
    want = np.asarray(jbpm.bpm_batch(
        jnp.asarray(texts), jnp.asarray(n),
        jbpm.build_peq(jnp.asarray(pats), jnp.asarray(m)), jnp.asarray(m),
        int(n.max()) + 64))
    t = torch.from_numpy
    peq_seq = bpm.build_table(t(tok), t(np.minimum(lens, 1024)), 16)
    got = bpm.bpm_batch(t(tok), t(ti), t(pi), t(n), t(m), peq_seq).numpy()
    assert np.array_equal(got, want)
    # and each against the native kernel, pair by pair
    for k, (a, b) in enumerate(pairs):
        ref = jnative.lib().kt_bpm_block(
            np.ascontiguousarray(tok[a, :lens[a]]),
            np.ascontiguousarray(tok[b, :lens[b]]), int(lens[a]),
            int(lens[b]))
        assert got[k] == ref, (a, b)


def test_anchor_distances_match_native_bit_exact():
    """Per-pair orientation (the longer side is the text) and the f32
    length bias, as kt_dist_to_anchors."""
    rng = np.random.default_rng(5)
    lens = rng.integers(20, 200, size=24).astype(np.int32)
    lens[3] = 260
    lens[9] = 64
    tok = _tokens(lens, 6)
    codes = [tok[i, :lens[i]].copy() for i in range(len(lens))]
    anchors = [0, 3, 9, 17, 23]
    flat, off, ll = jnative.flatten_seqs(codes)
    want = np.zeros((len(codes), 8), np.float32)
    jnative.lib().kt_dist_to_anchors(
        flat, off, ll, len(codes), np.asarray(anchors, np.int32),
        len(anchors), want.reshape(-1), 1)
    got = distances.anchor_distances(codes, anchors, "cpu")
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("nblk", [1, 5, 16])
@pytest.mark.parametrize("plen", [1, 63, 64, 65, 1024, 1100])
def test_match_mask_table_equals_per_pair_masks(plen, nblk):
    """peq_seq[pat_idx], one table of every sequence as the CPU route
    builds it (bpm.build_table), equals kalign_tpu's tpu/bpm.py::build_peq
    of each pair's own pattern (its first min(len, 1024) symbols,
    zero-padded to nblk*64), bit for bit."""
    lens = np.array([plen, 3, 70, 200, 1100, plen], np.int32)
    tok = _tokens(lens, plen + nblk)
    m_seq = np.minimum(lens, 1024).astype(np.int32)
    table = bpm.build_table(torch.from_numpy(tok), torch.from_numpy(m_seq),
                            nblk)
    assert table.shape == (len(lens), bpm.SIGMA, nblk)
    pat_idx = np.array([0, 5, 1, 0, 2, 3, 4, 4, 5], np.int64)
    pats = np.zeros((len(pat_idx), jbpm.MAX_PATTERN), np.uint8)
    for k, p in enumerate(pat_idx):
        pats[k, :m_seq[p]] = tok[p, :m_seq[p]]
    # [P, 13, 16, 2] u32 (lo, hi) -> the first nblk 64-bit words
    want = np.asarray(jbpm.build_peq(jnp.asarray(pats),
                                     jnp.asarray(m_seq[pat_idx])))
    want = np.ascontiguousarray(want[:, :, :nblk]).view(np.int64)[..., 0]
    got = table[torch.from_numpy(pat_idx)].numpy()
    assert np.array_equal(got, want)


def _ballot_table(tok, m, nblk):
    """csrc/bpm.cu::peq_table_kernel's schedule in numpy: a warp per (row,
    word); lane l holds the codes at positions 64 b + l and 64 b + 32 + l
    (0 at or past L); per half word five ballots over the lanes give the
    bit planes (bit k of each code, k < 4, and code >= 16); lane s forms
    symbol s's mask as the AND of the planes or their complements by the
    bits of s, adds the bits at or past m and writes word (r, s, b)."""
    N, L = tok.shape
    full = (1 << 64) - 1
    shift = np.arange(32).astype(np.uint64)

    def ballot(pred):
        return int(np.sum(pred.astype(np.uint64) << shift))

    out = np.zeros((N, jbpm.SIGMA, nblk), np.uint64)
    for r in range(N):
        for b in range(nblk):
            pos = 64 * b + np.arange(32)
            c0, c1 = (np.where(p < L, tok[r, np.minimum(p, L - 1)], 0)
                      .astype(np.uint32) for p in (pos, pos + 32))
            plane = [ballot((c0 >> k) & 1 == 1) |
                     ballot((c1 >> k) & 1 == 1) << 32 for k in range(4)]
            high = ballot(c0 >= 16) | ballot(c1 >= 16) << 32
            rest = int(m[r]) - 64 * b
            beyond = (full if rest <= 0 else 0 if rest >= 64
                      else (full << rest) & full)
            for sym in range(jbpm.SIGMA):
                eq = ~high & full
                for k in range(4):
                    eq &= plane[k] if (sym >> k) & 1 else ~plane[k] & full
                out[r, sym, b] = np.uint64(eq | beyond)
    return out.view(np.int64)


@pytest.mark.parametrize("nblk", [1, 5, 16])
@pytest.mark.parametrize("L", [16, 80, 336, 1040])
def test_match_mask_table_by_warps_equals_plain_and_build_peq(L, nblk):
    """The table kernel's warp schedule (_ballot_table) on rows of width L
    (a multiple of 16, not of 64) whose codes past m are not zero, at
    lengths that are no multiple of 64, codes past the alphabet (13-15,
    16 and up) among them: plain_table's bits, and kalign_tpu's
    tpu/bpm.py::build_peq of each row's pattern (its first m codes,
    zero-padded) cut to nblk words."""
    rng = np.random.default_rng(L + nblk)
    lens = np.array([0, 1, 63, 65, 127, 200, 333, 1000, L], np.int32)
    m = np.minimum(np.minimum(lens, L), 1024).astype(np.int32)
    tok = rng.integers(0, 13, size=(len(lens), L)).astype(np.uint8)
    odd = rng.random(tok.shape) < 0.05
    tok[odd] = rng.choice(np.array([13, 15, 16, 29, 255], np.uint8),
                          size=int(odd.sum()))
    got = _ballot_table(tok, m, nblk)
    plain = bpm.plain_table(torch.from_numpy(tok), torch.from_numpy(m),
                            nblk).numpy()
    assert np.array_equal(got, plain)
    pats = np.zeros((len(lens), jbpm.MAX_PATTERN), np.uint8)
    for r in range(len(lens)):
        pats[r, :m[r]] = tok[r, :m[r]]
    want = np.asarray(jbpm.build_peq(jnp.asarray(pats), jnp.asarray(m)))
    want = np.ascontiguousarray(want[:, :, :nblk]).view(np.int64)[..., 0]
    assert np.array_equal(got, want)


def test_table_inputs_match_xla_bpm_batch():
    """bpm.bpm_batch on CPU tensors through distances.PairBatch's inputs
    (one mask table, indexed by pattern) equals kalign_tpu's
    tpu/bpm.py::bpm_batch on the same (text, pattern) pairs."""
    rng = np.random.default_rng(11)
    lens = rng.integers(1, 140, size=12).astype(np.int32)
    lens[[2, 7]] = (64, 65)
    tok = _tokens(lens, 12)
    pairs = distances.PairBatch(
        tok, lens, *distances.anchor_pairs(len(lens), [0, 2, 7]), "cpu")
    inp = pairs.inputs(0, pairs.n_pairs)
    got = bpm.bpm_batch(*inp).numpy()
    ti, pi = pairs.text_src, pairs.pat_src
    pats = np.zeros((pairs.n_pairs, 1024), np.uint8)
    for k, p in enumerate(pi):
        pats[k, :lens[p]] = tok[p, :lens[p]]
    m = np.minimum(lens[pi], 1024).astype(np.int32)
    want = np.asarray(jbpm.bpm_batch(
        jnp.asarray(tok[ti]), jnp.asarray(lens[ti]),
        jbpm.build_peq(jnp.asarray(pats), jnp.asarray(m)), jnp.asarray(m),
        int(lens.max()) + 64))
    assert np.array_equal(got, want)
    assert np.array_equal(pairs.tlen, lens[ti])
    assert np.array_equal(pairs.plen, m)


@pytest.mark.parametrize("nblk", range(1, bpm.NBLK + 1))
def test_bpm_launch_plan_covers_every_block_count(nblk):
    """Every block count a batch can need (1..16 blocks of 64 pattern
    symbols) has an instantiation, with whole warps and the shared
    memory of one block (none); anything else raises."""
    plan = bpm.launch_plan(nblk)
    assert plan.nblk == nblk
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.smem <= 232448
    for bad in (0, bpm.NBLK + 1):
        with pytest.raises(ValueError, match="no instantiation"):
            bpm.launch_plan(bad)
