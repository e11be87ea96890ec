"""Vectorized (numpy) profile state for the GPU engine (host side).

A node's profile is three dense arrays instead of the reference's
interleaved 64-float columns:

  counts  [L, 23]  weighted residue counts          (ref cols 0..22)
  subrows [L, 23]  substitution rows with historical
                   gap-penalty adjustments           (ref cols 32..54)
  pen     [L+2, 3] base -gpo/-gpe/-tgpe per column   (ref cols 55..57)

The DP consumes `pen * nsip_other` (ref cols 27..29) and
`match = counts_row @ subrows_col^T` (one batched fp32 matmul on the
card).
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class Profile:
    counts: np.ndarray   # [L, 23] f32
    subrows: np.ndarray  # [L, 23] f32
    pen: np.ndarray      # [L+2, 3] f32 — boundary cols 0 and L+1 included

    @property
    def length(self) -> int:
        return self.counts.shape[0]


def leaf_profile(seq_codes: np.ndarray, subm: np.ndarray, gpo: float,
                 gpe: float, tgpe: float, soff: float) -> Profile:
    L = len(seq_codes)
    counts = np.zeros((L, 23), dtype=np.float32)
    counts[np.arange(L), seq_codes] = 1.0
    subrows = (subm[seq_codes].astype(np.float32)
               - np.float32(soff)).astype(np.float32)
    pen = np.tile(np.array([-gpo, -gpe, -tgpe], dtype=np.float32), (L + 2, 1))
    return Profile(counts=counts, subrows=subrows, pen=pen)


def merge_profiles(pa: Profile, pb: Profile, steps: np.ndarray,
                   terminal: np.ndarray, sipa: int, sipb: int,
                   gpo: float, gpe: float, tgpe: float) -> Profile:
    """Merge two profiles along a 0/1/2 step path.

    Reproduces the reference default semantics: add_gap_info_to_path_n
    never sets open bits, so only extension / terminal-extension
    penalties are charged into substitution rows (aln_setup.c:196)."""
    n = len(steps)
    ai = np.cumsum(steps != 1) - 1   # row-side source index per output col
    bi = np.cumsum(steps != 2) - 1   # col-side source index
    is_m = steps == 0
    is_ga = steps == 1  # gap in A: copy B column
    is_gb = steps == 2

    counts = np.zeros((n, 23), dtype=np.float32)
    subrows = np.zeros((n, 23), dtype=np.float32)
    pen = np.zeros((n + 2, 3), dtype=np.float32)

    counts[is_m] = pa.counts[ai[is_m]] + pb.counts[bi[is_m]]
    subrows[is_m] = pa.subrows[ai[is_m]] + pb.subrows[bi[is_m]]
    counts[is_ga] = pb.counts[bi[is_ga]]
    subrows[is_ga] = pb.subrows[bi[is_ga]]
    counts[is_gb] = pa.counts[ai[is_gb]]
    subrows[is_gb] = pa.subrows[ai[is_gb]]

    # gap penalty adjustment of substitution rows
    gp = np.zeros(n, dtype=np.float32)
    gp[is_ga & terminal] = tgpe * sipa
    gp[is_ga & ~terminal] = gpe * sipa
    gp[is_gb & terminal] = tgpe * sipb
    gp[is_gb & ~terminal] = gpe * sipb
    subrows -= gp[:, None]

    # interior pen columns come from the source side column
    # (match: sum of both; gap: surviving side) — mirrors update_n's
    # copy of positions 55..57 (summed for match cols)
    pen_body = np.zeros((n, 3), dtype=np.float32)
    pen_body[is_m] = pa.pen[1:-1][ai[is_m]] + pb.pen[1:-1][bi[is_m]]
    pen_body[is_ga] = pb.pen[1:-1][bi[is_ga]]
    pen_body[is_gb] = pa.pen[1:-1][ai[is_gb]]
    pen[1:-1] = pen_body
    pen[0] = pa.pen[0] + pb.pen[0]
    pen[-1] = pa.pen[-1] + pb.pen[-1]
    return Profile(counts=counts, subrows=subrows, pen=pen)


def weave_steps(steps: np.ndarray, gaps, members_a, members_b):
    """Update member gap lists along a merge path (weave_alignment.c)."""
    n = len(steps)
    posa = np.cumsum(steps != 1)
    posb = np.cumsum(steps != 2)
    gap_a = np.bincount(posa[steps == 1], minlength=n + 1)
    gap_b = np.bincount(posb[steps == 2], minlength=n + 1)

    def apply(gis, newg):
        g = np.asarray(gis, dtype=np.int64)
        S = np.concatenate([[0], np.cumsum(newg)])
        rel = np.concatenate([[0], np.cumsum(g[:-1] + 1)])
        add = S[rel + g + 1] - S[rel]
        return (g + add).tolist()

    for m in members_a:
        gaps[m] = apply(gaps[m], gap_a)
    for m in members_b:
        gaps[m] = apply(gaps[m], gap_b)


def sp_score_from_profiles(pa: Profile, pb: Profile, steps: np.ndarray,
                           terminal: np.ndarray, nsip_a: int, nsip_b: int,
                           gaps_a: np.ndarray, gaps_b: np.ndarray,
                           subm: np.ndarray, gpo: float, gpe: float,
                           tgpe: float) -> float:
    """Expected cross-group sum-of-pairs of a merge candidate
    (compute_sp_score, lib/src/sp_score.c:75-201), in float64 as
    kalign_tpu/tpu/profile.py::sp_score_from_profiles :121 computes it.

    gaps_a/gaps_b: per-column gap counts of each side's current partial
    alignment (nsip - residue count per column)."""
    n = len(steps)
    ai = np.cumsum(steps != 1) - 1
    bi = np.cumsum(steps != 2) - 1
    is_m = steps == 0
    pen = np.where(terminal, np.float32(tgpe), np.float32(gpe))

    total = 0.0
    if is_m.any():
        fa = pa.counts[ai[is_m]]             # [M, 23]
        fb = pb.counts[bi[is_m]]
        total += float(np.einsum("mi,ij,mj->", fa, subm.astype(np.float64),
                                 fb, optimize=True))
        n_res_a = nsip_a - gaps_a[ai[is_m]]
        n_res_b = nsip_b - gaps_b[bi[is_m]]
        n_gap_a = gaps_a[ai[is_m]]
        n_gap_b = gaps_b[bi[is_m]]
        total -= float(np.sum((n_res_a * n_gap_b + n_gap_a * n_res_b)
                              * pen[is_m]))

    # gap runs: opens at run starts (gpo), per-column pen
    for side, is_g in ((0, steps == 1), (1, steps == 2)):
        if not is_g.any():
            continue
        if side == 0:
            n_res_other = nsip_b - gaps_b[bi[is_g]]
            n_pairs = nsip_a * n_res_other
        else:
            n_res_other = nsip_a - gaps_a[ai[is_g]]
            n_pairs = n_res_other * nsip_b
        total -= float(np.sum(n_pairs * pen[is_g]))
        opens = np.zeros(n, dtype=bool)
        g = is_g
        opens[0] = g[0]
        opens[1:] = g[1:] & ~g[:-1]
        sel = opens[is_g]
        total -= float(np.sum(n_pairs[sel]) * gpo)
    return total


def column_gap_counts(prof_len: int, nsip: int, members, lens,
                      gaps) -> np.ndarray:
    """Per-column gap count of a node's partial alignment
    (kalign_tpu/tpu/profile.py::column_gap_counts :170)."""
    out = np.full(prof_len, 0, dtype=np.int64)
    for si in members:
        g = np.asarray(gaps[si], dtype=np.int64)
        res_cols = np.cumsum(g[:-1] + 1) - 1
        has = np.zeros(prof_len, dtype=np.int64)
        has[res_cols] = 1
        out += 1 - has
    return out
