"""Pipeline driver: ties the data model to the GPU engine.

Counterpart of kalign_tpu/engine.py (align_msa :281-434) for the
default (anchor consistency) and ``--fast`` modes of the reference's
kalign_run_seeded (lib/src/aln_wrap.c:133-537):

  input check -> dealign -> sort len/name -> encode reduced -> anchors
  -> anchor distances -> guide tree (native, or the device k-means tree
  from 2,048 sequences on the card) -> encode full -> params
  -> consistency maps (default mode) -> progressive align (with
  refinement candidates when asked) -> finalise -> restore rank order

Engine "gpu-fast" (gpu/engine.py): hand-written CUDA kernels on the
card, level-batched merges and map DPs; score-optimal per merge, may
differ from the reference's Hirschberg midpoints on near-ties.  The
entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs every kernel's plain PyTorch version instead; without a card
they raise.
"""

from typing import List, Optional

import numpy as np
import torch

from kalign_tpu_torch.core import alphabet as alpha
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.core.msa import (ALN_STATUS_ALIGNED, BIOTYPE_DNA,
                                       BIOTYPE_PROTEIN, Msa)
from kalign_tpu_torch.gpu.consistency import ConsistencyTable
from kalign_tpu_torch.utils.logging import PhaseTimes, log, timer
from kalign_tpu_torch.utils.sorting import glibc_msort

ENGINES = ("gpu-fast",)


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: kalign_tpu_torch runs on "
                           "a GPU (pass device='cpu' to run the plain "
                           "PyTorch versions of its kernels)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pick_anchors(msa: Msa) -> List[int]:
    """Length-stride anchor selection (``pick_anchor.c:17-72``): sort ids
    by length descending (glibc qsort tie behavior), take every
    numseq/num_anchor-th."""
    n = msa.numseq
    num_anchor = min(32, n)
    order = glibc_msort(list(range(n)),
                        lambda x, y: -1 if msa.sequences[x].len >
                        msa.sequences[y].len else 1)
    stride = n // num_anchor
    return [order[i * stride] for i in range(num_anchor)]


def get_engine(name="gpu-fast", device=None):
    """The engine of a name, on ``device``; a GpuEngine passed as the name
    is used as it is (``GpuEngine(device, resident=False)`` runs the
    host-assembled progressive pass)."""
    from kalign_tpu_torch.gpu.engine import GpuEngine
    if isinstance(name, GpuEngine):
        return name
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r} (have {ENGINES})")
    return GpuEngine(resolve_device(device))


def _encoded(msa: Msa, kind: int):
    msa.encode(kind)
    return [sq.s for sq in msa.sequences]


def resolve_params(msa: Msa, type_: int, gpo: float, gpe: float,
                   tgpe: float, n_threads: int) -> P.AlnParam:
    type_ = P.resolve_pfasum_auto(type_, msa.biotype,
                                  [sq.len for sq in msa.sequences])
    return P.aln_param_init(msa.biotype, type_, gpo, gpe, tgpe, n_threads)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not available in kalign_tpu_torch "
                              "yet (default and --fast modes are)")


def align_msa(msa: Msa, n_threads: int = 1, type_: int = 0,
              gpo: float = -1.0, gpe: float = -1.0, tgpe: float = -1.0,
              refine: int = P.REFINE_NONE, adaptive_budget: int = 0,
              tree_seed: int = 0, tree_noise: float = 0.0,
              dist_scale: float = 0.0, vsm_amax: float = -1.0,
              use_seq_weights: float = -1.0,
              consistency_anchors: int = 0, consistency_weight: float = 2.0,
              realign: int = 0,
              engine="gpu-fast",
              save_checkpoint: Optional[str] = None,
              resume_checkpoint: Optional[str] = None,
              device=None) -> Msa:
    """Full alignment pipeline: default mode with consistency_anchors > 0
    (the reference's default is 5), --fast mode with 0; refine one of
    P.REFINE_NONE, REFINE_ALL, REFINE_CONFIDENT, REFINE_INLINE.  Options
    of the reference pipeline that this package does not run yet raise
    NotImplementedError.  ``engine`` is a name of ENGINES or a GpuEngine
    (get_engine)."""
    if realign > 0:
        _not_ported("realignment")
    if save_checkpoint is not None or resume_checkpoint is not None:
        _not_ported("checkpointing")
    if tree_noise > 0.0:
        _not_ported("guide-tree noise")
    eng = get_engine(engine, device)
    quiet = msa.quiet

    msa.essential_input_check()
    if msa.aligned != 1:  # ALN_STATUS_UNALIGNED
        msa.dealign()
    msa.sort_len_name()

    if msa.biotype == BIOTYPE_DNA:
        log("Detected DNA sequences.", quiet)
        _encoded(msa, alpha.ALPHA_DEFAULT_DNA)
    elif msa.biotype == BIOTYPE_PROTEIN:
        log("Detected protein sequences.", quiet)
        _encoded(msa, alpha.ALPHA_REDUCED_PROTEIN)
    else:
        raise ValueError("Unable to determine what alphabet to use.")

    phases = PhaseTimes()
    log("Calculating pairwise distances", quiet)
    with timer("Distances + guide tree", quiet):
        anchors = pick_anchors(msa)
        codes = [sq.s for sq in msa.sequences]
        with phases.phase("distances"):
            dm = eng.anchor_distances(codes, anchors)
        with phases.phase("tree"):
            tasks, seq_dist = eng.build_tree(codes, dm, len(anchors))
    msa.seq_distances = seq_dist
    # the JAX engine routes divergent families to its bit-exact engine;
    # that engine has no counterpart here yet
    mean_sd = float(np.mean(np.asarray(seq_dist, np.float64)))
    if mean_sd > 0.5:
        log(f"Divergent family (mean distance {mean_sd:.2f}): the exact "
            "engine is not available, aligning with gpu-fast", quiet)

    if msa.biotype == BIOTYPE_PROTEIN:
        _encoded(msa, alpha.ALPHA_AMBIGUOUS_PROTEIN)

    ap = resolve_params(msa, type_, gpo, gpe, tgpe, n_threads)
    ap.adaptive_budget = adaptive_budget
    if use_seq_weights >= 0.0:
        ap.use_seq_weights = use_seq_weights
    if dist_scale > 0.0:
        ap.dist_scale = dist_scale
    if vsm_amax >= 0.0:
        ap.vsm_amax = vsm_amax
    if consistency_anchors > 0:
        ap.consistency_anchors = consistency_anchors
        ap.consistency_weight = consistency_weight

    codes = [sq.s for sq in msa.sequences]
    eng.set_alphabet(codes, ap.subm)
    ct = None
    if ap.consistency_anchors > 0:
        # the anchors of the consistency maps come from the BPM distances
        with phases.phase("consistency"):
            ct = ConsistencyTable.build(eng, codes, ap, msa.seq_distances,
                                        ap.consistency_anchors,
                                        ap.consistency_weight)
    # refinement scheduling (kalign_tpu/engine.py:389-402): with no
    # realignment the first pass takes the refine mode itself
    first_mode = refine
    log("Aligning", quiet)
    with timer("Alignment", quiet), phases.phase("progressive"):
        gaps, conf = eng.align(codes, tasks, ap, msa.seq_distances, ct,
                               refine_mode=first_mode)
    for sq, g in zip(msa.sequences, gaps):
        sq.gaps = g
    msa.aligned = ALN_STATUS_ALIGNED

    msa.finalise()
    msa.sort_rank()
    msa.task_confidence = conf
    msa.engine_stats = eng.stats
    msa.phase_times = dict(phases)
    return msa
