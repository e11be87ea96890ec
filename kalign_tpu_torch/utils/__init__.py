"""Alignment utilities — mirrors the reference python-kalign
``kalign.utils`` module (to_array, alignment_stats, consensus_sequence,
remove_gap_columns, pairwise_identity_matrix, trim_alignment), with
vectorized implementations; a copy of kalign_tpu/utils/__init__.py:12-117.

kalign_tpu's ``ensure_compile_cache`` (seeding JAX's persistent XLA
cache) has no counterpart: this package compiles no programs at run
time but its CUDA and native libraries, which utils/build.py caches in
``kalign_tpu_torch/_build/``, keyed by a hash of their sources and
flags."""

from collections import Counter
from typing import Dict, List, Optional

import numpy as np


def to_array(alignment: List[str]) -> np.ndarray:
    if not alignment:
        raise ValueError("Empty alignment provided")
    if len(set(len(s) for s in alignment)) > 1:
        raise ValueError("All sequences in alignment must have the same length")
    return np.array([list(s) for s in alignment], dtype="U1")


def _byte_array(alignment: List[str]) -> np.ndarray:
    return np.frombuffer("".join(alignment).encode("ascii"),
                         dtype=np.uint8).reshape(len(alignment), -1)


def alignment_stats(alignment: List[str]) -> Dict[str, float]:
    arr = _byte_array(alignment)
    n, length = arr.shape
    gap = arr == ord("-")
    gap_fraction = float(gap.sum()) / (n * length)

    conserved = 0
    for col in range(length):
        column = arr[~gap[:, col], col]
        if len(column) > 0 and (column == column[0]).all():
            conserved += 1
    conservation = conserved / length

    total_matches = 0
    total_comparisons = 0
    for i in range(n):
        for j in range(i + 1, n):
            valid = ~gap[i] & ~gap[j]
            nv = int(valid.sum())
            if nv:
                total_matches += int((arr[i, valid] == arr[j, valid]).sum())
                total_comparisons += nv
    identity = total_matches / total_comparisons if total_comparisons else 0.0
    return {
        "length": length,
        "n_sequences": n,
        "gap_fraction": gap_fraction,
        "conservation": conservation,
        "identity": identity,
    }


def consensus_sequence(alignment: List[str], threshold: float = 0.5) -> str:
    if not alignment:
        raise ValueError("Empty alignment provided")
    if not 0 <= threshold <= 1:
        raise ValueError("Threshold must be between 0 and 1")
    arr = to_array(alignment)
    all_chars = set("".join(alignment).upper().replace("-", ""))
    ambiguous = "N" if all_chars.issubset(set("ATCGUN")) else "X"
    out = []
    for col in range(arr.shape[1]):
        column = arr[:, col]
        non_gap = column[column != "-"]
        if len(non_gap) == 0:
            out.append("-")
            continue
        ch, count = Counter(non_gap).most_common(1)[0]
        out.append(ch if count / len(non_gap) >= threshold else ambiguous)
    return "".join(out)


def remove_gap_columns(alignment: List[str], threshold: float = 1.0) -> List[str]:
    if not alignment:
        raise ValueError("Empty alignment provided")
    if not 0 <= threshold <= 1:
        raise ValueError("Threshold must be between 0 and 1")
    arr = _byte_array(alignment)
    gap_frac = (arr == ord("-")).mean(axis=0)
    keep = gap_frac < threshold
    if not keep.any():
        return [""] * len(alignment)
    kept = arr[:, keep]
    return [row.tobytes().decode("ascii") for row in kept]


def pairwise_identity_matrix(alignment: List[str]) -> np.ndarray:
    if not alignment:
        raise ValueError("Empty alignment provided")
    arr = _byte_array(alignment)
    n = arr.shape[0]
    out = np.eye(n)
    gap = arr == ord("-")
    for i in range(n):
        for j in range(i + 1, n):
            valid = ~gap[i] & ~gap[j]
            nv = int(valid.sum())
            ident = float((arr[i, valid] == arr[j, valid]).sum()) / nv if nv else 0.0
            out[i, j] = out[j, i] = ident
    return out


def trim_alignment(alignment: List[str], start: Optional[int] = None,
                   end: Optional[int] = None) -> List[str]:
    if not alignment:
        raise ValueError("Empty alignment provided")
    length = len(alignment[0])
    start = 0 if start is None else (max(0, length + start) if start < 0 else start)
    end = length if end is None else (max(0, length + end) if end < 0 else end)
    if start >= end:
        raise ValueError("Start position must be less than end position")
    return [s[start:end] for s in alignment]
