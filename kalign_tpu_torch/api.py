"""Public Python API of the PyTorch/CUDA port.

Mirrors kalign_tpu/api.py's ``align`` for the modes this package runs
(default: anchor consistency with 5 anchors; fast: none), with the
default scoring model.  ``device`` defaults to ``cuda``; ``device="cpu"``
runs every kernel's plain PyTorch version.
"""

from typing import Optional, Sequence

from kalign_tpu_torch import engine as _engine
from kalign_tpu_torch.core.msa import Msa


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
              consistency_weight: float = 2.0, engine="gpu-fast") -> Msa:
    """Align and return the finalised Msa (input order restored);
    ``engine`` as engine.align_msa takes it."""
    consistency = _resolve_mode(mode, consistency)
    _validate_sequences(sequences)
    msa = Msa.from_sequences(list(sequences),
                             list(names) if names else None)
    msa.quiet = True
    return _engine.align_msa(msa, consistency_anchors=consistency,
                             consistency_weight=consistency_weight,
                             engine=engine, device=device)


def align(sequences: Sequence[str], mode: Optional[str] = None,
          names: Optional[Sequence[str]] = None, device=None,
          consistency: Optional[int] = None,
          consistency_weight: float = 2.0):
    """Align sequences; returns the aligned rows in input order."""
    return align_msa(sequences, names=names, mode=mode, device=device,
                     consistency=consistency,
                     consistency_weight=consistency_weight).aligned_rows()
