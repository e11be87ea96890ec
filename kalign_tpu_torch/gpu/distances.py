"""N x K anchor distances through the BPM kernel.

Counterpart of kalign_tpu/parallel/mesh.py::pallas_anchor_distances
(:115-180) and the single-device length bias (:200-205), bit-exact with
the reference's d_estimation (sequence_distance.c:82-131): for every
(sequence, anchor) pair the longer side is the text and the shorter one
the pattern, capped at 1024 symbols (sequence_distance.c:153-162); the
integer distance gets the short-sequence preference bias
min(10000, (la + lb) // 2) / 10000 added in float32.

The token table goes to the device once, its rows padded to a multiple
of 16 bytes, and so does one match-mask table of every sequence (its
first min(len, 1024) symbols, bpm.build_table); each launch ships only
int32 index vectors.
"""

import numpy as np
import torch

from kalign_tpu_torch.gpu import bpm


class PairBatch:
    """The (text, pattern) pairs of every (sequence, anchor) pair, with
    the token table and the match-mask table on the device.
    ``inputs(lo, hi)`` gives the BPM kernel's arguments for pairs
    [lo, hi)."""

    def __init__(self, tokens: np.ndarray, lengths: np.ndarray, anchors,
                 device):
        N, Lmax = tokens.shape
        K = len(anchors)
        anchors = np.asarray(anchors, np.int32)
        lengths = np.asarray(lengths, np.int32)
        seq_idx = np.repeat(np.arange(N, dtype=np.int32), K)
        anc_idx = np.tile(np.arange(K, dtype=np.int32), N)
        li = lengths[seq_idx]
        lk = lengths[anchors][anc_idx]
        seq_is_text = li > lk
        self.text_src = np.where(seq_is_text, seq_idx,
                                 anchors[anc_idx]).astype(np.int32)
        self.pat_src = np.where(seq_is_text, anchors[anc_idx],
                                seq_idx).astype(np.int32)
        self.tlen = np.where(seq_is_text, li, lk).astype(np.int32)
        m_seq = np.minimum(lengths, bpm.MAX_PATTERN).astype(np.int32)
        self.plen = m_seq[self.pat_src]
        self.n_pairs = N * K
        self.nblk = max(1, (min(bpm.MAX_PATTERN, Lmax) + bpm.WORD - 1)
                        // bpm.WORD)
        self.device = device
        padded = np.zeros((N, Lmax + (-Lmax % 16)), np.uint8)
        padded[:, :Lmax] = tokens
        self.tok = torch.from_numpy(padded).to(device)
        self.peq = bpm.build_table(self.tok, torch.from_numpy(m_seq)
                                   .to(device), self.nblk)

    def inputs(self, lo: int, hi: int):
        """(tok, text_idx, pat_idx, n, m, peq_seq) for bpm.bpm_batch."""
        def put(x):
            return torch.from_numpy(x[lo:hi]).to(self.device)
        return (self.tok, put(self.text_src), put(self.pat_src),
                put(self.tlen), put(self.plen), self.peq)


def raw_distances_device(tokens: np.ndarray, lengths: np.ndarray, anchors,
                         device, chunk: int = 262144) -> torch.Tensor:
    """Integer edit distances [N * K] int32 on device, queued (no length
    bias)."""
    pairs = PairBatch(tokens, lengths, anchors, device)
    out = [bpm.bpm_batch(*pairs.inputs(lo, min(lo + chunk, pairs.n_pairs)))
           for lo in range(0, pairs.n_pairs, chunk)]
    return torch.cat(out)


def raw_distances(tokens: np.ndarray, lengths: np.ndarray, anchors,
                  device, chunk: int = 262144) -> np.ndarray:
    """Integer edit distances [N, K] (no length bias)."""
    return raw_distances_device(tokens, lengths, anchors, device,
                                chunk).cpu().numpy().reshape(len(tokens),
                                                             len(anchors))


def length_bias(lengths: np.ndarray, anchors) -> np.ndarray:
    """[N, K] float32 short-sequence preference bias."""
    lengths = np.asarray(lengths, np.int64)
    a_lens = lengths[np.asarray(anchors, np.int64)]
    s = (lengths[:, None] + a_lens[None, :]) // 2
    return (np.minimum(10000.0, s.astype(np.float64)) / 10000.0).astype(
        np.float32)


def token_table(codes):
    """(tokens [N, Lmax] uint8 zero-padded, lengths [N] int32)."""
    lens = np.array([len(c) for c in codes], np.int32)
    tokens = np.zeros((len(codes), max(1, int(lens.max()))), np.uint8)
    for i, c in enumerate(codes):
        tokens[i, :len(c)] = c
    return tokens, lens


def tree_layout(dm: np.ndarray) -> np.ndarray:
    """Biased distances [N, K] in the native tree builder's layout
    [N, ceil(K/8)*8] float32 (columns past K are 0)."""
    n, K = dm.shape
    out = np.zeros((n, ((K + 7) // 8) * 8), dtype=np.float32)
    out[:, :K] = dm
    return out


def anchor_distances(codes, anchors, device) -> np.ndarray:
    """Biased distances in the native tree builder's layout."""
    tokens, lens = token_table(codes)
    dm = raw_distances(tokens, lens, anchors, device)
    return tree_layout(dm.astype(np.float32) + length_bias(lens, anchors))
