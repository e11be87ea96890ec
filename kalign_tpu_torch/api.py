"""Public Python API of the PyTorch/CUDA port.

Mirrors kalign_tpu/api.py (and so python-kalign's surface): ``align``
(``fmt="plain"|"biopython"|"skbio"``, ``ids=``), ``align_from_file``,
``align_file_to_file``, ``read_alignment``, ``write_alignment``,
``generate_test_sequences``, ``compare``, ``compare_detailed``,
``compare_with_mask``, ``set_num_threads`` / ``get_num_threads`` (the
native runtime's threads; ``n_threads=None`` takes this default) and
``post_realign``, with the modes
(default: anchor consistency with 5 anchors; fast: none; precise: a
3-run ensemble with one realign pass), the scoring model's arguments
(seq_type, gap_open, gap_extend, terminal_gap_extend, vsm_amax,
dist_scale), refinement (refine=None, "none", "all", "confident",
"inline"), realign, the ensemble (ensemble, ensemble_seed, min_support)
and adaptive_budget (read by the native runtime of "host" and "gpu";
"gpu-fast" ignores it, as kalign_tpu's "tpu-fast" does).  ``engine`` is
one of engine.ENGINES ("gpu-fast", the default; "gpu", bit-exact;
"gpu-mesh", sharded over every visible card; "host", native only;
"auto", engine.resolve_auto_engine's choice) or an engine object, with
the divergent-family autoroute of "gpu-fast" and "gpu-mesh"
(``autoroute``, ``autoroute_max``; an ensemble's runs take the default
cap).  ``device`` defaults to ``cuda``; ``device="cpu"`` runs every
kernel's plain PyTorch version.
"""

from typing import List, Optional, Sequence, Union

from kalign_tpu_torch import engine as _engine
from kalign_tpu_torch import ensemble as _ensemble
from kalign_tpu_torch.core import io as kio
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.core.msa import Msa
from kalign_tpu_torch.utils.logging import recording
# a confidence's posterior-probability character (kalign_tpu/api.py:185):
# the Stockholm writer's rule
from kalign_tpu_torch.io import _conf_to_pp_char as _conf_to_pp

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

# kalign_tpu/api.py:38-50
_DEFAULT_THREADS = 1


def set_num_threads(n: int) -> None:
    """Set the default worker-thread count for the native runtime."""
    global _DEFAULT_THREADS
    if n < 1:
        raise ValueError("Thread count must be >= 1")
    _DEFAULT_THREADS = n


def get_num_threads() -> int:
    return _DEFAULT_THREADS


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
              n_threads: Optional[int] = None) -> Msa:
    """Align and return the finalised Msa (input order restored);
    ``engine``, ``autoroute`` and ``autoroute_max`` as engine.align_msa
    takes them.  With ensemble > 0 (mode "precise": 3) the runs go
    through ensemble.ensemble_align (kalign_tpu/api.py:98-123), which
    takes neither dist_scale nor adaptive_budget.  Each call is one
    record of spans with an id of its own (utils/logging.py): the
    arguments' checks and the Msa's construction are its first "input";
    the returned Msa holds the spans (``spans``) and their seconds by
    name (``phase_times``)."""
    with recording(fresh=True) as rec:
        with rec.span("input"):
            consistency, ensemble, realign = _resolve_mode(
                mode, consistency, ensemble, realign)
            if n_threads is None:
                n_threads = get_num_threads()
            type_ = _resolve_type(seq_type)
            refine_ = _resolve_refine(refine)
            _validate_sequences(sequences)
            msa = Msa.from_sequences(list(sequences),
                                     list(names) if names else None)
            msa.quiet = True
        if ensemble > 0:
            msa = _ensemble.ensemble_align(
                msa, n_threads=n_threads, type_=type_, n_runs=ensemble,
                gpo=gap_open, gpe=gap_extend, tgpe=terminal_gap_extend,
                seed=ensemble_seed, min_support=min_support, refine=refine_,
                vsm_amax=vsm_amax, realign=realign,
                consistency_anchors=consistency,
                consistency_weight=consistency_weight, engine=engine,
                device=device, autoroute=autoroute)
        else:
            msa = _engine.align_msa(
                msa, n_threads=n_threads, type_=type_, gpo=gap_open,
                gpe=gap_extend, tgpe=terminal_gap_extend, refine=refine_,
                adaptive_budget=int(adaptive_budget), realign=realign,
                vsm_amax=vsm_amax, dist_scale=dist_scale,
                consistency_anchors=consistency,
                consistency_weight=consistency_weight, engine=engine,
                device=device, autoroute=autoroute,
                autoroute_max=autoroute_max)
    rec.attach(msa)
    return msa


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
          adaptive_budget: bool = False, n_threads: Optional[int] = None,
          fmt: str = "plain", ids: Optional[Sequence[str]] = None):
    """Align sequences (kalign_tpu/api.py::align :132-182).  fmt:
    "plain" (the aligned rows in input order), "biopython"
    (Bio.Align.MultipleSeqAlignment, with PP annotations when the
    ensemble gave confidences) or "skbio" (TabularMSA).  ids names the
    sequences when names is not given."""
    if ids is not None and names is None:
        names = ids
    msa = align_msa(sequences, names=names, mode=mode, device=device,
                    consistency=consistency,
                    consistency_weight=consistency_weight,
                    seq_type=seq_type, gap_open=gap_open,
                    gap_extend=gap_extend,
                    terminal_gap_extend=terminal_gap_extend, refine=refine,
                    vsm_amax=vsm_amax, engine=engine, autoroute=autoroute,
                    autoroute_max=autoroute_max, ensemble=ensemble,
                    ensemble_seed=ensemble_seed, min_support=min_support,
                    realign=realign, dist_scale=dist_scale,
                    adaptive_budget=adaptive_budget, n_threads=n_threads)
    rows = msa.aligned_rows()
    if fmt == "plain":
        return rows
    out_names = [sq.name for sq in msa.sequences]
    if fmt == "biopython":
        return _to_biopython(msa, rows, out_names)
    if fmt == "skbio":
        return _to_skbio(msa, rows, out_names)
    raise ValueError(f"Unknown fmt {fmt!r}")


# kalign_tpu/api.py:185-233
def _to_biopython(msa, rows, names):
    try:
        from Bio.Align import MultipleSeqAlignment
        from Bio.Seq import Seq
        from Bio.SeqRecord import SeqRecord
    except ImportError as e:
        raise ImportError(
            "Biopython required for fmt='biopython'. "
            "Run: pip install biopython") from e
    records = []
    for i, (row, name) in enumerate(zip(rows, names)):
        rec = SeqRecord(Seq(row), id=name, description="")
        conf = msa.sequences[i].confidence
        if conf is not None:
            pp = "".join("." if ch in "-." else _conf_to_pp(c)
                         for ch, c in zip(row, conf))
            rec.letter_annotations["posterior_probability"] = pp
        records.append(rec)
    aln = MultipleSeqAlignment(records)
    if msa.col_confidence is not None:
        aln.column_annotations = {
            "posterior_probability":
                "".join(_conf_to_pp(c) for c in msa.col_confidence)}
    return aln


def _to_skbio(msa, rows, names):
    try:
        from skbio import DNA, Protein, RNA, TabularMSA
    except ImportError as e:
        raise ImportError(
            "scikit-bio required for fmt='skbio'. "
            "Run: pip install scikit-bio") from e
    alphabet = set("".join(rows).upper().replace("-", ""))
    if alphabet.issubset(set("ACGTN")):
        cls = DNA
    elif alphabet.issubset(set("ACGUN")):
        cls = RNA
    else:
        cls = Protein
    seqs = [cls(row, metadata={"id": name})
            for row, name in zip(rows, names)]
    return TabularMSA(seqs)


# kalign_tpu/api.py:236-316
def align_from_file(path: str, out_format: str = "plain", **kw):
    """Align the sequences of a file; ``out_format`` is align's fmt, the
    other keywords are align's."""
    msa = kio.read_inputs([path])
    return align([sq.seq for sq in msa.sequences],
                 names=[sq.name for sq in msa.sequences], fmt=out_format,
                 **kw)


def align_file_to_file(in_path: str, out_path: str,
                       out_format: str = "fasta", **kw) -> None:
    """Align the sequences of in_path into out_path (a format of
    core/io.py: fasta, msf, clu, sto); the other keywords are
    align_msa's."""
    msa = kio.read_inputs([in_path])
    out = align_msa([sq.seq for sq in msa.sequences],
                    names=[sq.name for sq in msa.sequences], **kw)
    kio.write_alignment_file(out, out_path, out_format)


def read_alignment(path: str) -> Msa:
    return kio.read_alignment(path)


def write_alignment(msa_or_rows, path: str, fmt: str = "fasta",
                    names: Optional[List[str]] = None):
    if isinstance(msa_or_rows, Msa):
        msa = msa_or_rows
    else:
        msa = Msa.from_sequences(list(msa_or_rows), names)
        msa.finalise()
    kio.write_alignment_file(msa, path, fmt)


def generate_test_sequences(n_seq: int = 20, n_obs: int = 10,
                            dna: bool = False, length: int = 250,
                            seed: int = 42):
    """Profile-HMM simulated families (bit-exact DSSim port):
    (sequences, names)."""
    from kalign_tpu_torch.dssim import generate_test_sequences as gen
    return gen(n_seq, n_obs, dna, length, seed)


def compare(reference, test, ref_names=None, test_names=None) -> float:
    """SP agreement %.  Accepts file paths or row lists."""
    from kalign_tpu_torch.core.cmp import msa_compare
    ref_rows, ref_names = _rows_arg(reference, ref_names)
    test_rows, test_names = _rows_arg(test, test_names)
    return msa_compare(ref_rows, test_rows, ref_names, test_names)


def compare_detailed(reference, test, ref_names=None, test_names=None,
                     max_gap_frac: float = 1.0, column_mask=None):
    """Recall, precision, F1 and TC (core/cmp.py::DetailedScore).
    ``column_mask`` (0/1 per reference column, kalign_msa_compare_with_mask,
    msa_cmp.c:449-480) replaces the gap-fraction rule for the core
    columns; its length must equal the reference alignment's."""
    from kalign_tpu_torch.core.cmp import msa_compare_detailed
    ref_rows, ref_names = _rows_arg(reference, ref_names)
    test_rows, test_names = _rows_arg(test, test_names)
    return msa_compare_detailed(ref_rows, test_rows, ref_names, test_names,
                                max_gap_frac, scored_cols=column_mask)


def compare_with_mask(reference, test, column_mask,
                      ref_names=None, test_names=None):
    """Score only the reference columns whose mask entry is truthy;
    ValueError when the mask length is not the reference alignment's."""
    return compare_detailed(reference, test, ref_names, test_names,
                            column_mask=column_mask)


def post_realign(msa_or_path, out_path: Optional[str] = None,
                 out_format: str = "fasta", seq_type=None,
                 gap_open: float = -1.0, gap_extend: float = -1.0,
                 terminal_gap_extend: float = -1.0,
                 refine=None, adaptive_budget: int = 0,
                 dist_scale: float = 0.0, vsm_amax: float = -1.0,
                 realign_iterations: int = 1, use_seq_weights: float = -1.0,
                 n_threads: Optional[int] = None, engine="gpu-fast",
                 device=None) -> Msa:
    """Realign an existing alignment (kalign_tpu/api.py::post_realign
    :319-353, kalign_post_realign): rebuild the guide tree from the
    alignment's identity distances and re-run the progressive pass.
    Accepts an ``Msa`` or a path to an aligned file; writes to
    ``out_path`` when given and always returns the realigned Msa."""
    msa = kio.read_alignment(msa_or_path) \
        if isinstance(msa_or_path, str) else msa_or_path
    msa = _engine.post_realign_msa(
        msa, n_threads=n_threads or get_num_threads(),
        type_=_resolve_type(seq_type),
        gpo=gap_open, gpe=gap_extend, tgpe=terminal_gap_extend,
        refine=_resolve_refine(refine), adaptive_budget=adaptive_budget,
        dist_scale=dist_scale, vsm_amax=vsm_amax,
        realign_iterations=realign_iterations,
        use_seq_weights=use_seq_weights, engine=engine, device=device)
    if out_path is not None:
        kio.write_alignment_file(msa, out_path, out_format)
    return msa


def _rows_arg(arg, names):
    """(rows, names) of a path (read, finalised) or of rows as given."""
    if isinstance(arg, str):
        msa = kio.read_alignment(arg)
        if msa.aligned == 2:
            msa.finalise()
        return ([sq.seq for sq in msa.sequences],
                [sq.name for sq in msa.sequences])
    return list(arg), names
