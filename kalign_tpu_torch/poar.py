"""POAR (pairwise aligned-residue) support tables.

For every sequence pair (i<j) the table stores the set of residue pairs
(pos_i, pos_j) that were aligned in at least one ensemble run, with a
32-bit per-run support mask.  Keys are packed ``(pos_i << 20) | pos_j``
(20-bit positions) and kept sorted (reference: lib/src/poar.c:10-19,45-82).
Stored as per-pair sorted int64 key arrays + uint32 mask arrays; all
operations are vectorized merges / binary searches.

Binary file format preserved bit-for-bit ("POAR", version 1,
little-endian; poar.c:203-325), so kalign_tpu and this package read each
other's files.  A copy of kalign_tpu/poar.py, with merge_poar_tables from
kalign_tpu/parallel/distributed.py:42 (that module imports JAX).
"""

import struct
from typing import List

import numpy as np

POAR_MAGIC = 0x524F4150
POAR_VERSION = 1
MAX_RUNS = 32

_EMPTY_K = np.empty(0, dtype=np.int64)
_EMPTY_M = np.empty(0, dtype=np.uint32)


def pair_index(i: int, j: int, numseq: int) -> int:
    return i * numseq - (i * (i + 1)) // 2 + (j - i - 1)


def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32).copy()
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


class PoarTable:
    def __init__(self, numseq: int):
        self.numseq = numseq
        self.n_alignments = 0
        self.n_pairs = numseq * (numseq - 1) // 2
        self.keys: List[np.ndarray] = [_EMPTY_K] * self.n_pairs
        self.masks: List[np.ndarray] = [_EMPTY_M] * self.n_pairs
        self._support: List[np.ndarray] = [None] * self.n_pairs

    # ------------------------------------------------------------------
    def extract(self, pos: np.ndarray, aln_idx: int):
        """Record aligned residue pairs of one run.  ``pos`` is the
        [numseq, alnlen] column->residue-index matrix (-1 for gaps)."""
        assert aln_idx < MAX_RUNS, "Maximum 32 alignments supported in ensemble"
        n = self.numseq
        bit = np.uint32(1 << aln_idx)
        pos64 = pos.astype(np.int64)
        valid = pos >= 0
        for i in range(n - 1):
            pi = pos64[i]
            vi = valid[i]
            for j in range(i + 1, n):
                both = vi & valid[j]
                # keys are strictly increasing along columns
                new_keys = (pi[both] << 20) | pos64[j][both]
                p = pair_index(i, j, n)
                old_keys = self.keys[p]
                if len(old_keys) == 0:
                    self.keys[p] = new_keys
                    self.masks[p] = np.full(len(new_keys), bit, dtype=np.uint32)
                    continue
                # merge sorted unique arrays
                merged = np.union1d(old_keys, new_keys)
                mm = np.zeros(len(merged), dtype=np.uint32)
                mm[np.searchsorted(merged, old_keys)] = self.masks[p]
                idx_new = np.searchsorted(merged, new_keys)
                mm[idx_new] |= bit
                self.keys[p] = merged
                self.masks[p] = mm
        if aln_idx >= self.n_alignments:
            self.n_alignments = aln_idx + 1
        self._support = [None] * self.n_pairs

    def _sup(self, p: int) -> np.ndarray:
        if self._support[p] is None:
            self._support[p] = _popcount32(self.masks[p])
        return self._support[p]

    # ------------------------------------------------------------------
    def score_alignment(self, pos: np.ndarray) -> float:
        """Expected other-run agreement score (consensus_msa.c:694-740)."""
        n = self.numseq
        denom = float(self.n_alignments - 1) if self.n_alignments > 1 else 1.0
        total = 0.0
        pos64 = pos.astype(np.int64)
        valid = pos >= 0
        for i in range(n - 1):
            pi = pos64[i]
            vi = valid[i]
            for j in range(i + 1, n):
                both = vi & valid[j]
                keys = (pi[both] << 20) | pos64[j][both]
                ks = self.keys[pair_index(i, j, n)]
                if len(ks):
                    sup = self._sup(pair_index(i, j, n))
                    idx = np.searchsorted(ks, keys)
                    idx = np.minimum(idx, len(ks) - 1)
                    support = np.where(ks[idx] == keys, sup[idx], 0)
                    total += float(np.sum((support - 1) / denom))
                else:
                    total += float(len(keys) * (-1.0 / denom))
        return total

    def lookup_support(self, i: int, j: int, keys: np.ndarray) -> np.ndarray:
        p = pair_index(i, j, self.numseq)
        ks = self.keys[p]
        if len(ks) == 0:
            return np.zeros(len(keys), dtype=np.int32)
        sup = self._sup(p)
        idx = np.searchsorted(ks, keys)
        idx = np.minimum(idx, len(ks) - 1)
        return np.where(ks[idx] == keys, sup[idx], 0)

    # ------------------------------------------------------------------
    def write(self, path: str):
        with open(path, "wb") as fh:
            fh.write(struct.pack("<IIII", POAR_MAGIC, POAR_VERSION,
                                 self.numseq, self.n_alignments))
            for p in range(self.n_pairs):
                ks = self.keys[p]
                fh.write(struct.pack("<I", len(ks)))
                if len(ks):
                    buf = np.empty(2 * len(ks), dtype=np.uint32)
                    buf[0::2] = ks.astype(np.uint32)
                    buf[1::2] = self.masks[p]
                    fh.write(buf.tobytes())

    @classmethod
    def read(cls, path: str) -> "PoarTable":
        with open(path, "rb") as fh:
            magic, version, numseq, n_alignments = struct.unpack(
                "<IIII", fh.read(16))
            if magic != POAR_MAGIC:
                raise ValueError(f"Invalid POAR file magic in {path}")
            if version != POAR_VERSION:
                raise ValueError(f"Unsupported POAR file version {version}")
            t = cls(numseq)
            t.n_alignments = n_alignments
            for p in range(t.n_pairs):
                (n_entries,) = struct.unpack("<I", fh.read(4))
                if n_entries:
                    buf = np.frombuffer(fh.read(8 * n_entries), dtype=np.uint32)
                    t.keys[p] = buf[0::2].astype(np.int64)
                    t.masks[p] = buf[1::2].copy()
        return t


def pos_matrix(rows: List[str]) -> np.ndarray:
    """Column -> residue index per sequence; -1 at gaps
    (pos_matrix_from_msa, poar.c:123-154)."""
    n = len(rows)
    alnlen = len(rows[0])
    out = np.full((n, alnlen), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        arr = np.frombuffer(r.encode("ascii"), dtype=np.uint8)
        isres = ((arr >= 65) & (arr <= 90)) | ((arr >= 97) & (arr <= 122))
        out[i, isres] = np.cumsum(isres)[isres] - 1
    return out


def merge_poar_tables(tables):
    """OR-merge per-run POAR support masks gathered from all workers
    (kalign_tpu/parallel/distributed.py::merge_poar_tables :42)."""
    base = tables[0]
    for other in tables[1:]:
        assert other.numseq == base.numseq
        for p in range(base.n_pairs):
            if len(other.keys[p]) == 0:
                continue
            if len(base.keys[p]) == 0:
                base.keys[p] = other.keys[p].copy()
                base.masks[p] = other.masks[p].copy()
                continue
            merged = np.union1d(base.keys[p], other.keys[p])
            mm = np.zeros(len(merged), dtype=np.uint32)
            mm[np.searchsorted(merged, base.keys[p])] |= base.masks[p]
            idx = np.searchsorted(merged, other.keys[p])
            mm[idx] |= other.masks[p]
            base.keys[p] = merged
            base.masks[p] = mm
        base.n_alignments = max(base.n_alignments, other.n_alignments)
    base._support = [None] * base.n_pairs
    return base
