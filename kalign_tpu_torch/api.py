"""Public Python API of the PyTorch/CUDA port.

Mirrors kalign_tpu/api.py's ``align`` for the modes this package runs
(default: anchor consistency with 5 anchors; fast: none), with the
scoring model's arguments (seq_type, gap_open, gap_extend,
terminal_gap_extend, vsm_amax) and refinement (refine=None, "none",
"all", "confident", "inline").  ``engine`` is one of engine.ENGINES
("gpu-fast", the default; "gpu", bit-exact; "host", native only), with
the divergent-family autoroute of "gpu-fast" (``autoroute``,
``autoroute_max``).  ``device`` defaults to ``cuda``; ``device="cpu"``
runs every kernel's plain PyTorch version.
"""

from typing import Optional, Sequence, Union

from kalign_tpu_torch import engine as _engine
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.core.msa import Msa

# kalign_tpu/api.py:16-35
_TYPE_NAMES = {
    None: 0,
    "auto": 0,
    "protein": P.KALIGN_TYPE_PROTEIN,
    "dna": P.KALIGN_TYPE_DNA,
    "internal": P.KALIGN_TYPE_DNA_INTERNAL,
    "rna": P.KALIGN_TYPE_RNA,
    "divergent": P.KALIGN_TYPE_PROTEIN_DIVERGENT,
    "pfasum43": P.KALIGN_TYPE_PROTEIN_PFASUM43,
    "pfasum60": P.KALIGN_TYPE_PROTEIN_PFASUM60,
    "pfasum": P.KALIGN_TYPE_PROTEIN_PFASUM_AUTO,
}

_REFINE_NAMES = {
    None: P.REFINE_NONE,
    "none": P.REFINE_NONE,
    "all": P.REFINE_ALL,
    "confident": P.REFINE_CONFIDENT,
    "inline": P.REFINE_INLINE,
}


def _resolve_type(seq_type) -> int:
    if isinstance(seq_type, int):
        return seq_type
    try:
        return _TYPE_NAMES[seq_type]
    except KeyError:
        raise ValueError(f"Unknown sequence type {seq_type!r}") from None


def _resolve_refine(refine) -> int:
    if isinstance(refine, int):
        return refine
    try:
        return _REFINE_NAMES[refine]
    except KeyError:
        raise ValueError(f"Unknown refine mode {refine!r}") from None


def _resolve_mode(mode: Optional[str], consistency: Optional[int]) -> int:
    """Anchor-consistency count of a mode preset (kalign_tpu/api.py:62-75,
    run_kalign.c:370-383): default -> 5, fast -> 0."""
    if mode not in (None, "default", "fast", "precise"):
        raise ValueError(f"Unknown mode {mode!r}")
    if mode == "precise":
        raise NotImplementedError(
            "mode 'precise' (ensemble + realign) is not available in "
            "kalign_tpu_torch yet (modes None/'default' and 'fast' are)")
    if consistency is None:
        consistency = 0 if mode == "fast" else 5
    return consistency


def _validate_sequences(sequences):
    if sequences is None or len(sequences) < 2:
        raise ValueError("Need at least 2 sequences to align")
    for i, s in enumerate(sequences):
        if not isinstance(s, str):
            raise TypeError(f"Sequence {i} is not a string")
        if not s:
            raise ValueError(f"Sequence {i} is empty")
        for ch in s:
            o = ord(ch)
            if o < 32 or o > 126:
                raise ValueError(
                    f"Sequence {i} contains control/non-ASCII character")
            if ch.isdigit():
                raise ValueError(f"Sequence {i} contains digits")


def align_msa(sequences: Sequence[str],
              names: Optional[Sequence[str]] = None,
              mode: Optional[str] = None, device=None,
              consistency: Optional[int] = None,
              consistency_weight: float = 2.0, engine="gpu-fast",
              seq_type: Union[str, int, None] = "auto",
              gap_open: float = -1.0, gap_extend: float = -1.0,
              terminal_gap_extend: float = -1.0,
              refine: Union[str, int, None] = None,
              vsm_amax: float = -1.0, autoroute: bool = True,
              autoroute_max: int = _engine.AUTOROUTE_MAX) -> Msa:
    """Align and return the finalised Msa (input order restored);
    ``engine``, ``autoroute`` and ``autoroute_max`` as engine.align_msa
    takes them."""
    consistency = _resolve_mode(mode, consistency)
    type_ = _resolve_type(seq_type)
    refine_ = _resolve_refine(refine)
    _validate_sequences(sequences)
    msa = Msa.from_sequences(list(sequences),
                             list(names) if names else None)
    msa.quiet = True
    return _engine.align_msa(msa, type_=type_, gpo=gap_open, gpe=gap_extend,
                             tgpe=terminal_gap_extend, refine=refine_,
                             vsm_amax=vsm_amax,
                             consistency_anchors=consistency,
                             consistency_weight=consistency_weight,
                             engine=engine, device=device,
                             autoroute=autoroute,
                             autoroute_max=autoroute_max)


def align(sequences: Sequence[str], mode: Optional[str] = None,
          names: Optional[Sequence[str]] = None, device=None,
          consistency: Optional[int] = None,
          consistency_weight: float = 2.0,
          seq_type: Union[str, int, None] = "auto",
          gap_open: float = -1.0, gap_extend: float = -1.0,
          terminal_gap_extend: float = -1.0,
          refine: Union[str, int, None] = None, vsm_amax: float = -1.0,
          engine="gpu-fast", autoroute: bool = True,
          autoroute_max: int = _engine.AUTOROUTE_MAX):
    """Align sequences; returns the aligned rows in input order."""
    return align_msa(sequences, names=names, mode=mode, device=device,
                     consistency=consistency,
                     consistency_weight=consistency_weight,
                     seq_type=seq_type, gap_open=gap_open,
                     gap_extend=gap_extend,
                     terminal_gap_extend=terminal_gap_extend, refine=refine,
                     vsm_amax=vsm_amax, engine=engine, autoroute=autoroute,
                     autoroute_max=autoroute_max).aligned_rows()
