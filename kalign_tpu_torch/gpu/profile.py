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
