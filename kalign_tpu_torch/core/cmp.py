"""Alignment comparison metrics (reference: lib/src/msa_cmp.c); a copy of
kalign_tpu/core/cmp.py.

``msa_compare`` — SP agreement %: identical aligned-residue partner
codes + identical residue-vs-gap codes over the reference totals
(msa_cmp.c:37-129).  ``msa_compare_detailed`` — recall (BAliBASE SP),
precision, F1, and TC over core columns whose reference gap fraction is
<= max_gap_frac (msa_cmp.c:269-483).

Rows are matched by sorting both alignments by (name, GCG checksum) with
glibc-qsort tie semantics, exactly like kalign_sort_msa.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from kalign_tpu_torch.core.msa import gcg_checksum
from kalign_tpu_torch.utils.sorting import glibc_msort


@dataclass
class DetailedScore:
    recall: float
    precision: float
    f1: float
    tc: float
    ref_pairs: int
    test_pairs: int
    common: int


def _sorted_rows(rows: List[str], names: Optional[List[str]]):
    if names is None:
        names = [f"seq{i}" for i in range(len(rows))]
    recs = []
    for name, row in zip(names, rows):
        ungapped_len = sum(1 for ch in row if ch.isalpha())
        # reference checksums the first `len` chars of the gapped string
        recs.append((name, gcg_checksum(row[:ungapped_len]), row))

    def cmp(a, b):
        if a[0][:256] < b[0][:256]:
            return -1
        if a[0][:256] == b[0][:256]:
            return -1 if a[1] > b[1] else 1
        return 1

    return [r[2] for r in glibc_msort(recs, cmp)]


def _res_mask(row: str) -> np.ndarray:
    arr = np.frombuffer(row.encode("ascii"), dtype=np.uint8)
    return ((arr >= 65) & (arr <= 90)) | ((arr >= 97) & (arr <= 122))


def msa_compare(ref_rows: List[str], test_rows: List[str],
                ref_names=None, test_names=None) -> float:
    r = _sorted_rows(ref_rows, ref_names)
    t = _sorted_rows(test_rows, test_names)
    n = len(r)
    rmask = [_res_mask(x) for x in r]
    tmask = [_res_mask(x) for x in t]
    rpos = [np.cumsum(m) - 1 for m in rmask]
    tpos = [np.cumsum(m) - 1 for m in tmask]

    identical_aligned = 0
    identical_gaps = 0
    ref_aligned = 0
    ref_gaps = 0
    for i in range(n):
        for j in range(i + 1, n):
            # partner code arrays for both orientations in both alignments
            cA1 = np.where(rmask[j], rpos[j], -1)[rmask[i]]
            cA2 = np.where(rmask[i], rpos[i], -1)[rmask[j]]
            cB1 = np.where(tmask[j], tpos[j], -1)[tmask[i]]
            cB2 = np.where(tmask[i], tpos[i], -1)[tmask[j]]
            both = int(np.sum(cA1 >= 0))
            ref_aligned += 2 * both
            ref_gaps += int(np.sum(cA1 < 0)) + int(np.sum(cA2 < 0))
            eq1 = cA1 == cB1
            eq2 = cA2 == cB2
            identical_aligned += int(np.sum(eq1 & (cA1 >= 0)))
            identical_aligned += int(np.sum(eq2 & (cA2 >= 0)))
            identical_gaps += int(np.sum(eq1 & (cA1 < 0)))
            identical_gaps += int(np.sum(eq2 & (cA2 < 0)))
    denom = ref_aligned + ref_gaps
    if denom == 0:
        return 0.0
    return 100.0 * (identical_aligned + identical_gaps) / denom


def msa_compare_detailed(ref_rows: List[str], test_rows: List[str],
                         ref_names=None, test_names=None,
                         max_gap_frac: float = 1.0,
                         scored_cols: Optional[np.ndarray] = None) -> DetailedScore:
    r = _sorted_rows(ref_rows, ref_names)
    t = _sorted_rows(test_rows, test_names)
    n = len(r)
    alnlen_r = len(r[0])
    rmask = np.stack([_res_mask(x) for x in r])
    tmask = np.stack([_res_mask(x) for x in t])
    rpos = np.cumsum(rmask, axis=1) - 1
    tpos = np.cumsum(tmask, axis=1) - 1

    if scored_cols is None:
        if max_gap_frac < 0.0:
            scored = np.ones(alnlen_r, dtype=bool)
        else:
            gap_frac = 1.0 - rmask.sum(axis=0) / float(n)
            scored = gap_frac.astype(np.float32) <= np.float32(max_gap_frac)
    else:
        scored = np.asarray(scored_cols).astype(bool)
        if scored.shape[0] != alnlen_r:
            raise ValueError(
                "Mask length (%d) != reference alignment length (%d)"
                % (scored.shape[0], alnlen_r))

    ref_scored_pairs = 0
    test_pairs = 0
    common_scored = 0
    common_all = 0
    for i in range(n):
        for j in range(i + 1, n):
            cA1 = np.where(rmask[j], rpos[j], -1)[rmask[i]]
            cA2 = np.where(rmask[i], rpos[i], -1)[rmask[j]]
            sc1 = (scored & rmask[j])[rmask[i]]
            sc2 = (scored & rmask[i])[rmask[j]]
            cB1 = np.where(tmask[j], tpos[j], -1)[tmask[i]]
            cB2 = np.where(tmask[i], tpos[i], -1)[tmask[j]]
            ref_scored_pairs += int(np.sum(sc1 & (cA1 >= 0)))
            ref_scored_pairs += int(np.sum(sc2 & (cA2 >= 0)))
            test_pairs += 2 * int(np.sum(cB1 >= 0))
            m1 = (cA1 >= 0) & (cA1 == cB1)
            m2 = (cA2 >= 0) & (cA2 == cB2)
            common_all += int(np.sum(m1)) + int(np.sum(m2))
            common_scored += int(np.sum(m1 & sc1)) + int(np.sum(m2 & sc2))

    # TC: scored reference columns (>=2 residues) whose residues all land
    # in the same test column
    res_counts = rmask.sum(axis=0)
    tcol_of_res = np.full((n, alnlen_r), -1, dtype=np.int64)
    for s in range(n):
        res_to_tcol = np.nonzero(tmask[s])[0]
        cols = np.nonzero(rmask[s])[0]
        tcol_of_res[s, cols] = res_to_tcol[rpos[s][cols]]
    tc_total = 0
    tc_correct = 0
    eligible = scored & (res_counts >= 2)
    for c in np.nonzero(eligible)[0]:
        tcols = tcol_of_res[rmask[:, c], c]
        tc_total += 1
        if np.all(tcols == tcols[0]):
            tc_correct += 1

    recall = common_scored / ref_scored_pairs if ref_scored_pairs > 0 else 0.0
    precision = common_all / test_pairs if test_pairs > 0 else 0.0
    f1 = (2 * recall * precision / (recall + precision)
          if recall + precision > 0 else 0.0)
    tc = tc_correct / tc_total if tc_total > 0 else 0.0
    return DetailedScore(recall=recall, precision=precision, f1=f1, tc=tc,
                         ref_pairs=ref_scored_pairs, test_pairs=test_pairs,
                         common=common_scored)
