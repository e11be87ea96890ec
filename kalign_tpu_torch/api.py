"""Public Python API of the PyTorch/CUDA port (--fast mode).

Mirrors kalign_tpu/api.py's ``align`` for the mode this package runs,
with the default scoring model.  ``device`` defaults to ``cuda``;
``device="cpu"`` runs every kernel's plain PyTorch version.
"""

from typing import Optional, Sequence

from kalign_tpu_torch import engine as _engine
from kalign_tpu_torch.core.msa import Msa


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
              names: Optional[Sequence[str]] = None, mode: str = "fast",
              device=None) -> Msa:
    """Align and return the finalised Msa (input order restored)."""
    if mode != "fast":
        raise NotImplementedError(
            f"mode {mode!r} is not available in kalign_tpu_torch yet "
            "(only mode='fast' is)")
    _validate_sequences(sequences)
    msa = Msa.from_sequences(list(sequences),
                             list(names) if names else None)
    msa.quiet = True
    return _engine.align_msa(msa, consistency_anchors=0, device=device)


def align(sequences: Sequence[str], mode: str = "fast",
          names: Optional[Sequence[str]] = None, device=None):
    """Align sequences; returns the aligned rows in input order."""
    return align_msa(sequences, names=names, mode=mode,
                     device=device).aligned_rows()
