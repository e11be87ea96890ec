"""Alignment parameters: substitution matrices and gap penalties.

Numeric data transcribed from the reference (``lib/src/aln_param.c``) so
that alignments are bit-identical:

  * PFASUM43  (default protein; Keul et al. 2017, 1/3-bit units)
    gpo=7.0 gpe=1.25 tgpe=1.0                     (aln_param.c:202-244)
  * PFASUM60  (auto-selected for len-ratio >= 1.5) (aln_param.c:250-291)
  * gon250    (--type divergent)  gpo=55 gpe=8 tgpe=4 (aln_param.c:111-151)
  * CorBLOSUM66_13plus (legacy)   gpo=5.5 gpe=2 tgpe=1 (aln_param.c:153-197)
  * DNA +-5/-4 gpo=8 gpe=6 tgpe=0 (internal: tgpe=8)  (aln_param.c:293-325)
  * RNA ribosum-style +283 offset, gpo=217 gpe=39.4 tgpe=292.6
                                                   (aln_param.c:327-363)

Matrix rows/cols are in internal ambiguous-protein code order
"ARNDCQEGHILKMFPSTWYVBZX" (see core.alphabet).
"""

from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# public type codes — mirror include/kalign/kalign.h
# ---------------------------------------------------------------------------
KALIGN_TYPE_UNDEFINED = 0
KALIGN_TYPE_PROTEIN = 1
KALIGN_TYPE_DNA = 2
KALIGN_TYPE_DNA_INTERNAL = 3
KALIGN_TYPE_RNA = 4
KALIGN_TYPE_PROTEIN_DIVERGENT = 5
KALIGN_TYPE_PROTEIN_PFASUM43 = 6
KALIGN_TYPE_PROTEIN_PFASUM60 = 7
KALIGN_TYPE_PROTEIN_PFASUM_AUTO = 8

BIOTYPE_PROTEIN = 0
BIOTYPE_DNA = 1
BIOTYPE_UNDEF = 2

REFINE_NONE = 0
REFINE_ALL = 1
REFINE_CONFIDENT = 2
REFINE_INLINE = 3

# the engines the API and the CLI take (engine.py; here so that the CLI
# parses its flags without importing torch)
ENGINES = ("gpu-fast", "gpu", "gpu-mesh", "host", "auto")

_PFASUM43_ROWS = """
 4 -1 -1 -1  0  0 -1  0 -2 -1 -1 -1  0 -2 -1  1  0 -2 -2  0  0  0  0
-1  6  0  0 -3  2  1 -2  1 -3 -3  3 -2 -3 -1  0  0 -2 -2 -3  0  0  0
-1  0  6  2 -2  1  1  0  1 -4 -4  1 -2 -3 -1  1  0 -3 -2 -3  0  0  0
-1  0  2  6 -4  1  3  0  0 -5 -5  0 -4 -5  0  0  0 -4 -3 -4  0  0  0
 0 -3 -2 -4 13 -3 -4 -2 -2 -1 -1 -4  0 -1 -3  0 -1 -2 -1  0  0  0  0
 0  2  1  1 -3  5  2 -1  1 -3 -3  2 -1 -3 -1  0  0 -3 -2 -2  0  0  0
-1  1  1  3 -4  2  5 -1  0 -4 -4  2 -3 -4 -1  0  0 -4 -3 -3  0  0  0
 0 -2  0  0 -2 -1 -1  7 -2 -4 -4 -1 -3 -4 -1  0 -1 -3 -3 -3  0  0  0
-2  1  1  0 -2  1  0 -2  9 -3 -3  0 -2 -1 -1  0 -1 -1  2 -3  0  0  0
-1 -3 -4 -5 -1 -3 -4 -4 -3  5  2 -3  2  1 -3 -3 -1 -1 -1  3  0  0  0
-1 -3 -4 -5 -1 -3 -4 -4 -3  2  4 -3  2  2 -3 -3 -2  0  0  2  0  0  0
-1  3  1  0 -4  2  2 -1  0 -3 -3  5 -2 -4 -1  0  0 -3 -2 -3  0  0  0
 0 -2 -2 -4  0 -1 -3 -3 -2  2  2 -2  6  1 -3 -2 -1  0  0  1  0  0  0
-2 -3 -3 -5 -1 -3 -4 -4 -1  1  2 -4  1  7 -3 -3 -2  3  4  0  0  0  0
-1 -1 -1  0 -3 -1 -1 -1 -1 -3 -3 -1 -3 -3  9  0 -1 -3 -3 -2  0  0  0
 1  0  1  0  0  0  0  0  0 -3 -3  0 -2 -3  0  4  2 -3 -2 -2  0  0  0
 0  0  0  0 -1  0  0 -1 -1 -1 -2  0 -1 -2 -1  2  4 -3 -2  0  0  0  0
-2 -2 -3 -4 -2 -3 -4 -3 -1 -1  0 -3  0  3 -3 -3 -3 13  3 -2  0  0  0
-2 -2 -2 -3 -1 -2 -3 -3  2 -1  0 -2  0  4 -3 -2 -2  3  8 -1  0  0  0
 0 -3 -3 -4  0 -2 -3 -3 -3  3  2 -3  1  0 -2 -2  0 -2 -1  4  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
"""

_PFASUM60_ROWS = """
 5 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -3  0  0  0  0
-1  7  0 -1 -4  2  0 -2  1 -4 -3  3 -2 -4 -2 -1 -1 -3 -2 -3  0  0  0
-2  0  7  2 -3  1  0  0  1 -5 -4  1 -3 -4 -1  1  0 -4 -2 -4  0  0  0
-2 -1  2  7 -5  1  3 -1  0 -6 -6  0 -4 -6 -1  0 -1 -5 -4 -5  0  0  0
 0 -4 -3 -5 14 -4 -5 -2 -2 -1 -1 -4 -1 -1 -4  0 -1 -2 -1  0  0  0  0
-1  2  1  1 -4  6  2 -2  1 -4 -3  2 -1 -4 -1  0  0 -3 -2 -3  0  0  0
-1  0  0  3 -5  2  6 -2  0 -5 -4  1 -3 -5 -1  0 -1 -5 -3 -4  0  0  0
 0 -2  0 -1 -2 -2 -2  8 -2 -5 -5 -2 -4 -5 -2  0 -2 -4 -4 -4  0  0  0
-2  1  1  0 -2  1  0 -2 10 -4 -3  0 -2 -1 -2 -1 -1 -1  2 -3  0  0  0
-1 -4 -5 -6 -1 -4 -5 -5 -4  6  3 -4  2  1 -4 -3 -1 -2 -2  4  0  0  0
-1 -3 -4 -6 -1 -3 -4 -5 -3  3  5 -4  3  2 -4 -4 -2 -1 -1  1  0  0  0
-1  3  1  0 -4  2  1 -2  0 -4 -4  6 -2 -5 -1  0  0 -4 -3 -3  0  0  0
-1 -2 -3 -4 -1 -1 -3 -4 -2  2  3 -2  8  1 -4 -2 -1 -1 -1  1  0  0  0
-2 -4 -4 -6 -1 -4 -5 -5 -1  1  2 -5  1  8 -4 -3 -3  3  4  0  0  0  0
-1 -2 -1 -1 -4 -1 -1 -2 -2 -4 -4 -1 -4 -4 10  0 -1 -4 -4 -3  0  0  0
 1 -1  1  0  0  0  0  0 -1 -3 -4  0 -2 -3  0  5  2 -4 -3 -2  0  0  0
 0 -1  0 -1 -1  0 -1 -2 -1 -1 -2  0 -1 -3 -1  2  6 -3 -2  0  0  0  0
-3 -3 -4 -5 -2 -3 -5 -4 -1 -2 -1 -4 -1  3 -4 -4 -3 14  3 -2  0  0  0
-3 -2 -2 -4 -1 -2 -3 -4  2 -2 -1 -3 -1  4 -4 -3 -2  3  9 -2  0  0  0
 0 -3 -4 -5  0 -3 -4 -4 -3  4  1 -3  1  0 -3 -2  0 -2 -2  5  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
"""

_GON250_ROWS = """
 24  -6  -3  -3   5  -2   0   5  -8  -8 -12  -4  -7 -23   3  11   6 -36 -22   1   0   0   0
 -6  47   3  -3 -22  15   4 -10   6 -24 -22  27 -17 -32  -9  -2  -2 -16 -18 -20   0   0   0
 -3   3  38  22 -18   7   9   4  12 -28 -30   8 -22 -31  -9   9   5 -36 -14 -22   0   0   0
 -3  -3  22  47 -32   9  27   1   4 -38 -40   5 -30 -45  -7   5   0 -52 -28 -29   0   0   0
  5 -22 -18 -32 115 -24 -30 -20 -13 -11 -15 -28  -9  -8 -31   1  -5 -10  -5   0   0   0   0
 -2  15   7   9 -24  27  17 -10  12 -19 -16  15 -10 -26  -2   2   0 -27 -17 -15   0   0   0
  0   4   9  27 -30  17  36  -8   4 -27 -28  12 -20 -39  -5   2  -1 -43 -27 -19   0   0   0
  5 -10   4   1 -20 -10  -8  66 -14 -45 -44 -11 -35 -52 -16   4 -11 -40 -40 -33   0   0   0
 -8   6  12   4 -13  12   4 -14  60 -22 -19   6 -13  -1 -11  -2  -3  -8  22 -20   0   0   0
 -8 -24 -28 -38 -11 -19 -27 -45 -22  40  28 -21  25  10 -26 -18  -6 -18  -7  31   0   0   0
-12 -22 -30 -40 -15 -16 -28 -44 -19  28  40 -21  28  20 -23 -21 -13  -7   0  18   0   0   0
 -4  27   8   5 -28  15  12 -11   6 -21 -21  32 -14 -33  -6   1   1 -35 -21 -17   0   0   0
 -7 -17 -22 -30  -9 -10 -20 -35 -13  25  28 -14  43  16 -24 -14  -6 -10  -2  16   0   0   0
-23 -32 -31 -45  -8 -26 -39 -52  -1  10  20 -33  16  70 -38 -28 -22  36  51   1   0   0   0
  3  -9  -9  -7 -31  -2  -5 -16 -11 -26 -23  -6 -24 -38  76   4   1 -50 -31 -18   0   0   0
 11  -2   9   5   1   2   2   4  -2 -18 -21   1 -14 -28   4  22  15 -33 -19 -10   0   0   0
  6  -2   5   0  -5   0  -1 -11  -3  -6 -13   1  -6 -22   1  15  25 -35 -19   0   0   0   0
-36 -16 -36 -52 -10 -27 -43 -40  -8 -18  -7 -35 -10  36 -50 -33 -35 142  41 -26   0   0   0
-22 -18 -14 -28  -5 -17 -27 -40  22  -7   0 -21  -2  51 -31 -19 -19  41  78 -11   0   0   0
  1 -20 -22 -29   0 -15 -19 -33 -20  31  18 -17  16   1 -18 -10   0 -26 -11  34   0   0   0
  0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0
  0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0
  0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0
"""

_CORBLOSUM66_ROWS = """
 5 -1 -1 -2 -2 -1 -1  0 -2 -1 -1 -1  0 -2 -1  1  0 -2 -2  0 -2 -1  0
-1  6  0 -1 -3  1  1 -2  0 -2 -2  3 -1 -3 -1 -1 -1 -1 -1 -2  0  1 -1
-1  0  6  2 -3  1  0  0  0 -3 -3  0 -2 -2 -1  1  0 -2 -1 -2  4  0 -1
-2 -1  2  7 -3  1  2 -1 -1 -3 -3  0 -3 -3 -1  0 -1 -3 -2 -3  5  2 -1
-2 -3 -3 -3 12 -3 -4 -3 -2 -2 -3 -3 -2 -1 -3 -2 -2 -3 -2 -2 -3 -3 -2
-1  1  1  1 -3  5  2 -2  0 -2 -2  1  0 -2 -1  0  0 -1 -1 -2  1  3  0
-1  1  0  2 -4  2  6 -2 -1 -3 -3  1 -2 -3  0  0 -1 -2 -2 -2  1  4 -1
 0 -2  0 -1 -3 -2 -2  7 -2 -4 -4 -2 -3 -3 -2  0 -2 -3 -3 -3 -1 -2 -1
-2  0  0 -1 -2  0 -1 -2 10 -3 -3  0 -2 -2 -2 -1 -1 -2  1 -3  0  0 -1
-1 -2 -3 -3 -2 -2 -3 -4 -3  5  2 -2  2  0 -3 -2 -1 -1 -1  3 -3 -2 -1
-1 -2 -3 -3 -3 -2 -3 -4 -3  2  5 -2  3  1 -3 -3 -2  0 -1  1 -3 -2 -1
-1  3  0  0 -3  1  1 -2  0 -2 -2  5 -1 -3 -1  0  0 -2 -2 -2  0  1 -1
 0 -1 -2 -3 -2  0 -2 -3 -2  2  3 -1  6  1 -2 -1 -1  0 -1  1 -2 -1  0
-2 -3 -2 -3 -1 -2 -3 -3 -2  0  1 -3  1  7 -3 -2 -2  2  3  0 -3 -3 -1
-1 -1 -1 -1 -3 -1  0 -2 -2 -3 -3 -1 -2 -3  9  0 -1 -2 -2 -2 -1 -1 -1
 1 -1  1  0 -2  0  0  0 -1 -2 -3  0 -1 -2  0  4  2 -2 -2 -1  0  0  0
 0 -1  0 -1 -2  0 -1 -2 -1 -1 -2  0 -1 -2 -1  2  5 -1 -1  0  0  0  0
-2 -1 -2 -3 -3 -1 -2 -3 -2 -1  0 -2  0  2 -2 -2 -1 13  3 -2 -2 -2 -1
-2 -1 -1 -2 -2 -1 -2 -3  1 -1 -1 -2 -1  3 -2 -2 -1  3  9 -1 -2 -2 -1
 0 -2 -2 -3 -2 -2 -2 -3 -3  3  1 -2  1  0 -2 -1  0 -2 -1  4 -3 -2 -1
-2  0  4  5 -3  1  1 -1  0 -3 -3  0 -2 -3 -1  0  0 -2 -2 -3  4  1 -1
-1  1  0  2 -3  3  4 -2  0 -2 -2  1 -1 -3 -1  0  0 -2 -2 -2  1  4 -1
 0 -1 -1 -1 -2  0 -1 -1 -1 -1 -1 -1  0 -1 -1  0  0 -1 -1 -1 -1 -1 -1
"""


def _parse(rows: str) -> np.ndarray:
    m = np.array([[float(x) for x in line.split()] for line in rows.strip().splitlines()],
                 dtype=np.float32)
    assert m.shape == (23, 23)
    return m


PFASUM43 = _parse(_PFASUM43_ROWS)
PFASUM60 = _parse(_PFASUM60_ROWS)
GON250 = _parse(_GON250_ROWS)
CORBLOSUM66_13PLUS = _parse(_CORBLOSUM66_ROWS)


def _dna_matrix() -> np.ndarray:
    m = np.zeros((23, 23), dtype=np.float32)
    m[:5, :5] = -4.0
    np.fill_diagonal(m[:5, :5], 5.0)
    return m


def _rna_matrix() -> np.ndarray:
    m = np.zeros((23, 23), dtype=np.float32)
    m[:5, :5] = 283.0
    core = np.array(
        [
            [91.0, -114.0, -31.0, -123.0],
            [-114.0, 100.0, -125.0, -31.0],
            [-31.0, -125.0, 100.0, -114.0],
            [-123.0, -31.0, -114.0, 91.0],
        ],
        dtype=np.float32,
    )
    m[:4, :4] += core
    return m


DNA_MATRIX = _dna_matrix()
RNA_MATRIX = _rna_matrix()


@dataclass
class AlnParam:
    """Alignment scoring parameters (reference: ``struct aln_param``,
    ``lib/src/aln_param.h:19-34``)."""

    subm: np.ndarray = field(default_factory=lambda: PFASUM43.copy())
    gpo: float = 7.0
    gpe: float = 1.25
    tgpe: float = 1.0
    dist_scale: float = 0.0
    vsm_amax: float = 2.0
    subm_offset: float = 0.0
    adaptive_budget: int = 0
    use_seq_weights: float = 0.0
    consistency_anchors: int = 0
    consistency_weight: float = 2.0
    nthreads: int = 1

    def scaled(self, gap_scale: float, subm_offset: float) -> "AlnParam":
        """Shallow copy with distance-scaled penalties (aln_run.c:226-237)."""
        out = AlnParam(**self.__dict__)
        out.gpo = np.float32(np.float32(self.gpo) * np.float32(gap_scale))
        out.gpe = np.float32(np.float32(self.gpe) * np.float32(gap_scale))
        out.tgpe = np.float32(np.float32(self.tgpe) * np.float32(gap_scale))
        out.subm_offset = np.float32(subm_offset)
        return out


def aln_param_init(biotype: int, type_: int, gpo: float = -1.0, gpe: float = -1.0,
                   tgpe: float = -1.0, n_threads: int = 1) -> AlnParam:
    """Resolve matrix + penalties from biotype x type, mirroring
    ``aln_param_init`` (aln_param.c:17-107) including its mismatch errors."""
    ap = AlnParam(nthreads=n_threads)
    if biotype == BIOTYPE_DNA:
        if type_ == KALIGN_TYPE_DNA:
            ap.subm, ap.gpo, ap.gpe, ap.tgpe = DNA_MATRIX.copy(), 8.0, 6.0, 0.0
        elif type_ == KALIGN_TYPE_DNA_INTERNAL:
            ap.subm, ap.gpo, ap.gpe, ap.tgpe = DNA_MATRIX.copy(), 8.0, 6.0, 8.0
        elif type_ == KALIGN_TYPE_PROTEIN:
            raise ValueError("Detected DNA sequences but --type protein option was selected.")
        else:  # RNA and default
            ap.subm, ap.gpo, ap.gpe, ap.tgpe = RNA_MATRIX.copy(), 217.0, 39.4, 292.6
    elif biotype == BIOTYPE_PROTEIN:
        if type_ == KALIGN_TYPE_PROTEIN_DIVERGENT:
            ap.subm, ap.gpo, ap.gpe, ap.tgpe = GON250.copy(), 55.0, 8.0, 4.0
        elif type_ == KALIGN_TYPE_PROTEIN_PFASUM60:
            ap.subm, ap.gpo, ap.gpe, ap.tgpe = PFASUM60.copy(), 7.0, 1.25, 1.0
        elif type_ in (KALIGN_TYPE_DNA, KALIGN_TYPE_DNA_INTERNAL, KALIGN_TYPE_RNA):
            raise ValueError("Detected protein sequences but a nucleotide --type was selected.")
        else:  # PROTEIN, PFASUM43, default
            ap.subm, ap.gpo, ap.gpe, ap.tgpe = PFASUM43.copy(), 7.0, 1.25, 1.0
    else:
        raise ValueError("Unable to determine what alphabet to use.")

    if gpo >= 0.0:
        ap.gpo = gpo
    if gpe >= 0.0:
        ap.gpe = gpe
    if tgpe >= 0.0:
        ap.tgpe = tgpe
    ap.dist_scale = 0.0
    ap.vsm_amax = 2.0 if biotype == BIOTYPE_PROTEIN else 0.0
    ap.subm_offset = 0.0
    ap.use_seq_weights = 0.0
    ap.consistency_anchors = 0
    ap.consistency_weight = 2.0
    return ap


def resolve_pfasum_auto(type_: int, biotype: int, lengths) -> int:
    """PFASUM_AUTO rule: len-ratio < 1.5 -> PFASUM43 else PFASUM60
    (``aln_wrap.c:31-68``)."""
    if type_ != KALIGN_TYPE_PROTEIN_PFASUM_AUTO:
        return type_
    if biotype != BIOTYPE_PROTEIN:
        return KALIGN_TYPE_PROTEIN_PFASUM43
    lo, hi = min(lengths), max(lengths)
    ratio = (hi / lo) if lo > 0 else 1.0
    return KALIGN_TYPE_PROTEIN_PFASUM43 if ratio < 1.5 else KALIGN_TYPE_PROTEIN_PFASUM60


def aln_param_from_arrays(subm, gpo: float, gpe: float, tgpe: float,
                          dist_scale: float = 0.0, vsm_amax: float = 2.0,
                          subm_offset: float = 0.0, adaptive_budget: int = 0,
                          use_seq_weights: float = 0.0,
                          consistency_anchors: int = 0,
                          consistency_weight: float = 2.0,
                          nthreads: int = 1) -> AlnParam:
    """Build an ``AlnParam`` from plain numpy / python values: the
    scoring model is the whole of this system's state, so two
    implementations fed the same fields score every merge alike."""
    subm = np.array(subm, dtype=np.float32, copy=True)
    if subm.shape != (23, 23):
        raise ValueError(f"subm must be 23x23, got {subm.shape}")
    return AlnParam(subm=subm, gpo=gpo, gpe=gpe, tgpe=tgpe,
                    dist_scale=dist_scale, vsm_amax=vsm_amax,
                    subm_offset=subm_offset,
                    adaptive_budget=int(adaptive_budget),
                    use_seq_weights=use_seq_weights,
                    consistency_anchors=int(consistency_anchors),
                    consistency_weight=consistency_weight,
                    nthreads=int(nthreads))
