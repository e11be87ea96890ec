"""The bit-parallel edit distance's plain version (gpu/bpm.py, the
function of csrc/bpm.cu) and the anchor-distance stage (gpu/distances.py)
against kalign_tpu: tpu/bpm.py::bpm_batch (XLA) and the native
kt_dist_to_anchors / kt_bpm_block, bit-exact."""

import numpy as np
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
    peq = bpm.build_peq(t(pats), t(m), 16)
    got = bpm.bpm_batch(t(tok), t(ti), t(n), peq, t(m)).numpy()
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
