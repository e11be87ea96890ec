"""Pair distances through the BPM kernel: the N x K anchor distances and
the guide tree's leaf sets' pair distances.

Counterpart of kalign_tpu/parallel/mesh.py::pallas_anchor_distances
(:115-180) and the single-device length bias (:200-205), bit-exact with
the reference's d_estimation (sequence_distance.c:53-131): of a pair
(a, b) the longer side is the text and the shorter one the pattern,
capped at 1024 symbols, b the text on equal lengths
(sequence_distance.c:153-162); the integer distance gets the
short-sequence preference bias min(10000, (la + lb) // 2) / 10000 added
in float32.  The anchor grid's pairs are (sequence, anchor)
(``anchor_pairs``); the leaf sets' are the ones the native tree's UPGMA
reads (``leaf_pairs``).

The token table goes to the device once, its rows padded to a multiple
of 16 bytes, and so does one match-mask table of every sequence (its
first min(len, 1024) symbols, bpm.build_table); each launch ships only
int32 index vectors.
"""

import numpy as np
import torch

from kalign_tpu_torch.gpu import bpm


class PairBatch:
    """The (text, pattern) pairs of the pairs (a[p], b[p]) of rows of a
    token table -- the longer row the text, b[p] on equal lengths -- with
    the token table and the match-mask table on the device.
    ``inputs(lo, hi)`` gives the BPM kernel's arguments for pairs
    [lo, hi)."""

    def __init__(self, tokens: np.ndarray, lengths: np.ndarray, a, b,
                 device):
        N, Lmax = tokens.shape
        a = np.asarray(a, np.int32)
        b = np.asarray(b, np.int32)
        lengths = np.asarray(lengths, np.int32)
        a_is_text = lengths[a] > lengths[b]
        self.text_src = np.where(a_is_text, a, b).astype(np.int32)
        self.pat_src = np.where(a_is_text, b, a).astype(np.int32)
        self.tlen = lengths[self.text_src]
        m_seq = np.minimum(lengths, bpm.MAX_PATTERN).astype(np.int32)
        self.plen = m_seq[self.pat_src]
        self.n_pairs = len(a)
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


def anchor_pairs(n: int, anchors):
    """(a, b) of the anchor grid, row-major: every sequence i < n against
    each anchor, (i, anchors[k])."""
    anchors = np.asarray(anchors, np.int32)
    K = len(anchors)
    return (np.repeat(np.arange(n, dtype=np.int32), K),
            np.tile(anchors, n))


def leaf_pairs(sets):
    """The pairs the UPGMA of each leaf set reads, each distinct unordered
    pair once (native/src/kt_tree.cpp: leaf_distances): for members p < q
    of a set, in its order, the pair (a, b) = (set[q], set[p]).  Returns
    (a, b, cells, size): cells [P, 2] the pair's two cells (p, q) and
    (q, p) in the sets' ns x ns matrices laid one after another, flat, of
    ``size`` cells in all."""
    a, b = [np.zeros(0, np.int32)], [np.zeros(0, np.int32)]
    cells = [np.zeros((0, 2), np.int64)]
    at = 0
    for s in sets:
        ns = len(s)
        q, p = np.tril_indices(ns, -1)
        a.append(s[q])
        b.append(s[p])
        cells.append(np.stack([at + p * ns + q, at + q * ns + p], axis=1))
        at += ns * ns
    return (np.concatenate(a).astype(np.int32),
            np.concatenate(b).astype(np.int32), np.concatenate(cells), at)


def pair_distances_device(tokens: np.ndarray, lengths: np.ndarray, a, b,
                          device, chunk: int = 262144) -> torch.Tensor:
    """Integer edit distances [P] int32 of the pairs (a, b) on device,
    queued (no length bias)."""
    pairs = PairBatch(tokens, lengths, a, b, device)
    out = [bpm.bpm_batch(*pairs.inputs(lo, min(lo + chunk, pairs.n_pairs)))
           for lo in range(0, pairs.n_pairs, chunk)]
    return torch.cat(out)


def raw_distances_device(tokens: np.ndarray, lengths: np.ndarray, anchors,
                         device, chunk: int = 262144) -> torch.Tensor:
    """Integer edit distances [N * K] int32 on device, queued (no length
    bias)."""
    return pair_distances_device(tokens, lengths,
                                 *anchor_pairs(len(tokens), anchors),
                                 device, chunk)


def raw_distances(tokens: np.ndarray, lengths: np.ndarray, anchors,
                  device, chunk: int = 262144) -> np.ndarray:
    """Integer edit distances [N, K] (no length bias)."""
    return raw_distances_device(tokens, lengths, anchors, device,
                                chunk).cpu().numpy().reshape(len(tokens),
                                                             len(anchors))


def pair_bias(lengths: np.ndarray, a, b) -> np.ndarray:
    """[P] float32 short-sequence preference bias of the pairs (a, b)."""
    lengths = np.asarray(lengths, np.int64)
    s = (lengths[np.asarray(a, np.int64)]
         + lengths[np.asarray(b, np.int64)]) // 2
    return (np.minimum(10000.0, s.astype(np.float64)) / 10000.0).astype(
        np.float32)


def length_bias(lengths: np.ndarray, anchors) -> np.ndarray:
    """[N, K] float32 short-sequence preference bias."""
    return pair_bias(lengths, *anchor_pairs(len(lengths), anchors)).reshape(
        len(lengths), len(anchors))


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


def leaf_distances(codes, sets, device):
    """The leaf sets' pair distances for native.build_tree's
    ``pair_distances``, in one batch of leaf_pairs on ``device``:
    (the sets' ns x ns float32 matrices laid one after another, flat,
    the diagonal 0; the pairs computed)."""
    a, b, cells, size = leaf_pairs(sets)
    out = np.zeros(size, np.float32)
    if len(a):
        tokens, lens = token_table(codes)
        d = pair_distances_device(tokens, lens, a, b, device).cpu().numpy()
        out[cells] = (d.astype(np.float32) + pair_bias(lens, a, b))[:, None]
    return out, len(a)
