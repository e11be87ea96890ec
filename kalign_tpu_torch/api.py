"""Public Python API of the PyTorch/CUDA port.

Mirrors kalign_tpu/api.py's ``align`` and ``post_realign``: the modes
(default: anchor consistency with 5 anchors; fast: none; precise: a
3-run ensemble with one realign pass), the scoring model's arguments
(seq_type, gap_open, gap_extend, terminal_gap_extend, vsm_amax,
dist_scale), refinement (refine=None, "none", "all", "confident",
"inline"), realign, the ensemble (ensemble, ensemble_seed, min_support)
and adaptive_budget (read by the native runtime of "host" and "gpu";
"gpu-fast" ignores it, as kalign_tpu's "tpu-fast" does).  ``engine`` is
one of engine.ENGINES ("gpu-fast", the default; "gpu", bit-exact;
"host", native only), with the divergent-family autoroute of "gpu-fast"
(``autoroute``, ``autoroute_max``; an ensemble's runs take the default
cap).  ``device`` defaults to ``cuda``; ``device="cpu"`` runs every
kernel's plain PyTorch version.
"""

from typing import Optional, Sequence, Union

from kalign_tpu_torch import engine as _engine
from kalign_tpu_torch import ensemble as _ensemble
from kalign_tpu_torch.core import io as kio
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


def _resolve_mode(mode: Optional[str], consistency, ensemble, realign):
    """Mode presets (kalign_tpu/api.py:62-76, run_kalign.c:370-383):
    default -> consistency 5; fast -> consistency 0; precise -> ensemble
    3 + realign 1.  Returns (consistency, ensemble, realign)."""
    if mode not in (None, "default", "fast", "precise"):
        raise ValueError(f"Unknown mode {mode!r}")
    if consistency is None:
        consistency = 0 if mode == "fast" else 5
    if mode == "precise":
        if not ensemble:
            ensemble = 3
        if not realign:
            realign = 1
    return consistency, ensemble or 0, realign or 0


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
              autoroute_max: int = _engine.AUTOROUTE_MAX,
              ensemble: int = 0, ensemble_seed: int = 42,
              min_support: int = 0, realign: int = 0,
              dist_scale: float = 0.0, adaptive_budget: bool = False,
              n_threads: int = 1) -> Msa:
    """Align and return the finalised Msa (input order restored);
    ``engine``, ``autoroute`` and ``autoroute_max`` as engine.align_msa
    takes them.  With ensemble > 0 (mode "precise": 3) the runs go
    through ensemble.ensemble_align (kalign_tpu/api.py:98-123), which
    takes neither dist_scale nor adaptive_budget."""
    consistency, ensemble, realign = _resolve_mode(mode, consistency,
                                                   ensemble, realign)
    type_ = _resolve_type(seq_type)
    refine_ = _resolve_refine(refine)
    _validate_sequences(sequences)
    msa = Msa.from_sequences(list(sequences),
                             list(names) if names else None)
    msa.quiet = True
    if ensemble > 0:
        return _ensemble.ensemble_align(
            msa, n_threads=n_threads, type_=type_, n_runs=ensemble,
            gpo=gap_open, gpe=gap_extend, tgpe=terminal_gap_extend,
            seed=ensemble_seed, min_support=min_support, refine=refine_,
            vsm_amax=vsm_amax, realign=realign,
            consistency_anchors=consistency,
            consistency_weight=consistency_weight, engine=engine,
            device=device, autoroute=autoroute)
    return _engine.align_msa(msa, n_threads=n_threads, type_=type_,
                             gpo=gap_open, gpe=gap_extend,
                             tgpe=terminal_gap_extend, refine=refine_,
                             adaptive_budget=int(adaptive_budget),
                             realign=realign, vsm_amax=vsm_amax,
                             dist_scale=dist_scale,
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
          autoroute_max: int = _engine.AUTOROUTE_MAX,
          ensemble: int = 0, ensemble_seed: int = 42, min_support: int = 0,
          realign: int = 0, dist_scale: float = 0.0,
          adaptive_budget: bool = False, n_threads: int = 1):
    """Align sequences; returns the aligned rows in input order."""
    return align_msa(sequences, names=names, mode=mode, device=device,
                     consistency=consistency,
                     consistency_weight=consistency_weight,
                     seq_type=seq_type, gap_open=gap_open,
                     gap_extend=gap_extend,
                     terminal_gap_extend=terminal_gap_extend, refine=refine,
                     vsm_amax=vsm_amax, engine=engine, autoroute=autoroute,
                     autoroute_max=autoroute_max, ensemble=ensemble,
                     ensemble_seed=ensemble_seed, min_support=min_support,
                     realign=realign, dist_scale=dist_scale,
                     adaptive_budget=adaptive_budget,
                     n_threads=n_threads).aligned_rows()


def post_realign(msa_or_path, out_path: Optional[str] = None,
                 out_format: str = "fasta", seq_type=None,
                 gap_open: float = -1.0, gap_extend: float = -1.0,
                 terminal_gap_extend: float = -1.0,
                 refine=None, adaptive_budget: int = 0,
                 dist_scale: float = 0.0, vsm_amax: float = -1.0,
                 realign_iterations: int = 1, use_seq_weights: float = -1.0,
                 n_threads: int = 1, engine="gpu-fast",
                 device=None) -> Msa:
    """Realign an existing alignment (kalign_tpu/api.py::post_realign
    :319-353, kalign_post_realign): rebuild the guide tree from the
    alignment's identity distances and re-run the progressive pass.
    Accepts an ``Msa`` or a path to an aligned file; writes to
    ``out_path`` when given and always returns the realigned Msa."""
    msa = kio.read_alignment(msa_or_path) \
        if isinstance(msa_or_path, str) else msa_or_path
    msa = _engine.post_realign_msa(
        msa, n_threads=n_threads, type_=_resolve_type(seq_type),
        gpo=gap_open, gpe=gap_extend, tgpe=terminal_gap_extend,
        refine=_resolve_refine(refine), adaptive_budget=adaptive_budget,
        dist_scale=dist_scale, vsm_amax=vsm_amax,
        realign_iterations=realign_iterations,
        use_seq_weights=use_seq_weights, engine=engine, device=device)
    if out_path is not None:
        kio.write_alignment_file(msa, out_path, out_format)
    return msa
