"""The traceback walk's plain version (gpu/traceback.py, the walk of
csrc/traceback.cu) against kalign_tpu's device walks traceback_batch and
traceback_lanewise, on identical decisions: exact steps and counts."""

import numpy as np
import torch

import jax.numpy as jnp

from kalign_tpu.tpu.gotoh_lanewise import gotoh_forward_direct_np
from kalign_tpu.tpu.traceback import traceback_batch, traceback_lanewise
from kalign_tpu_torch.gpu import traceback as tb


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


def _pack_port(dec):
    """[B, L1p, L2p] -> this package's [L1p, L2p/8, B] (8 per int32)."""
    B, L1p, L2p = dec.shape
    d = dec.astype(np.int64).reshape(B, L1p, L2p // 8, 8)
    w = sum(d[..., u] << (4 * u) for u in range(8))
    w = np.transpose(w, (1, 2, 0))
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
        s_t, n_t = tb.walk_lanewise(t(_pack_port(dec)), t(la), t(lb), t(st),
                                    ms)
        assert np.array_equal(s_t.numpy(), np.asarray(s_j))
        assert np.array_equal(n_t.numpy(), np.asarray(n_j))
        # each walk consumes exactly la rows and lb columns
        s = s_t.numpy()
        assert np.array_equal(((s == 0) | (s == 2)).sum(1), la)
        assert np.array_equal(((s == 0) | (s == 1)).sum(1), lb)
