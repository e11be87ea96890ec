"""N x K anchor distances through the BPM kernel.

Counterpart of kalign_tpu/parallel/mesh.py::pallas_anchor_distances
(:115-180) and the single-device length bias (:200-205), bit-exact with
the reference's d_estimation (sequence_distance.c:82-131): for every
(sequence, anchor) pair the longer side is the text and the shorter one
the pattern, capped at 1024 symbols (sequence_distance.c:153-162); the
integer distance gets the short-sequence preference bias
min(10000, (la + lb) // 2) / 10000 added in float32.

The token table goes to the device once; each launch ships only int32
index vectors and builds the patterns' match masks on the device.
"""

import numpy as np
import torch

from kalign_tpu_torch.gpu import bpm

PEQ_SUB = 16384      # pairs whose match masks are built at once


class PairBatch:
    """The (text, pattern) pairs of every (sequence, anchor) pair, with
    the token table on the device.  ``inputs(lo, hi)`` gives the BPM
    kernel's arguments for pairs [lo, hi)."""

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
                                seq_idx).astype(np.int64)
        self.tlen = np.where(seq_is_text, li, lk).astype(np.int32)
        self.plen = np.minimum(np.where(seq_is_text, lk, li),
                               bpm.MAX_PATTERN).astype(np.int32)
        self.n_pairs = N * K
        pat_w = min(bpm.MAX_PATTERN, Lmax)
        self.nblk = max(1, (pat_w + bpm.WORD - 1) // bpm.WORD)
        self.device = device
        self.tok = torch.from_numpy(np.ascontiguousarray(tokens)).to(device)
        self.tok_pat = torch.zeros((N, self.nblk * bpm.WORD),
                                   dtype=torch.uint8, device=device)
        self.tok_pat[:, :pat_w] = self.tok[:, :pat_w]

    def inputs(self, lo: int, hi: int):
        """(tok, text_idx, n, peq, m) for bpm.bpm_batch."""
        def put(x):
            return torch.from_numpy(x[lo:hi]).to(self.device)
        ts, ps, nn, mm = (put(self.text_src), put(self.pat_src),
                          put(self.tlen), put(self.plen))
        peq = torch.cat([bpm.build_peq(self.tok_pat[ps[s:s + PEQ_SUB]],
                                       mm[s:s + PEQ_SUB], self.nblk)
                         for s in range(0, hi - lo, PEQ_SUB)])
        return self.tok, ts, nn, peq, mm


def raw_distances(tokens: np.ndarray, lengths: np.ndarray, anchors,
                  device, chunk: int = 262144) -> np.ndarray:
    """Integer edit distances [N, K] (no length bias)."""
    pairs = PairBatch(tokens, lengths, anchors, device)
    out = [bpm.bpm_batch(*pairs.inputs(lo, min(lo + chunk, pairs.n_pairs)))
           for lo in range(0, pairs.n_pairs, chunk)]
    return torch.cat(out).cpu().numpy().reshape(len(tokens), len(anchors))


def length_bias(lengths: np.ndarray, anchors) -> np.ndarray:
    """[N, K] float32 short-sequence preference bias."""
    lengths = np.asarray(lengths, np.int64)
    a_lens = lengths[np.asarray(anchors, np.int64)]
    s = (lengths[:, None] + a_lens[None, :]) // 2
    return (np.minimum(10000.0, s.astype(np.float64)) / 10000.0).astype(
        np.float32)


def anchor_distances(codes, anchors, device) -> np.ndarray:
    """Biased distances in the native tree builder's layout
    [N, ceil(K/8)*8] float32 (columns past K are 0)."""
    n = len(codes)
    lens = np.array([len(c) for c in codes], np.int32)
    Lmax = max(1, int(lens.max()))
    tokens = np.zeros((n, Lmax), np.uint8)
    for i, c in enumerate(codes):
        tokens[i, :len(c)] = c
    dm = raw_distances(tokens, lens, anchors, device)
    K = len(anchors)
    stride = ((K + 7) // 8) * 8
    out = np.zeros((n, stride), dtype=np.float32)
    out[:, :K] = dm.astype(np.float32) + length_bias(lens, anchors)
    return out
