"""Ensemble alignment (the core of --precise).

N alignment runs with per-run gap-penalty presets and optionally noisy
guide trees, POAR pair-support extraction, run selection vs union-find
consensus, and a post-selection REFINE_CONFIDENT pass
(reference: lib/src/ensemble.c).  A copy of kalign_tpu/ensemble.py: every
run goes through this package's engine.align_msa with the caller's
``engine``, ``device`` and ``autoroute`` (kalign_tpu's
KALIGN_TPU_NO_AUTOROUTE), so on the card each run's DPs take the card's
kernels; the POAR tables and the consensus are host work, as in
kalign_tpu.

The ensemble's stages are spans of the record under way
(utils/logging.py), so the finalised Msa carries them in ``spans`` and
``phase_times``: "runs" (the alignments, each a record of its own;
"runs.realign" the realign passes among them), "poar_extract",
"poar_score", "consensus", "post_selection" (the REFINE_CONFIDENT run)
and "confidence"; and ``engine_stats["ensemble"]``: the runs' scores,
the selected run, which of "selection" or "consensus" won, and the
engine that aligned each run.
"""

import glob
import os
from typing import List, Optional

import numpy as np

from kalign_tpu_torch import engine as E
from kalign_tpu_torch.consensus import build_consensus, residue_confidence
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.core.msa import Msa
from kalign_tpu_torch.poar import PoarTable, merge_poar_tables, pos_matrix
from kalign_tpu_torch.utils.logging import recording

# per-run gap-penalty presets (ensemble.c:32-46):
# (gpo_scale, gpe_scale, tgpe_scale, tree_noise_sigma)
RUN_PARAMS = [
    (1.0, 1.0, 1.0, 0.00),
    (0.5, 1.5, 0.8, 0.20),
    (1.5, 0.5, 1.2, 0.20),
    (0.7, 0.7, 0.5, 0.25),
    (1.4, 1.4, 1.5, 0.25),
    (0.8, 1.2, 1.0, 0.30),
    (1.3, 0.8, 0.7, 0.30),
    (0.6, 1.0, 1.3, 0.15),
    (1.0, 0.6, 0.6, 0.15),
    (1.8, 1.0, 1.0, 0.35),
    (1.0, 1.8, 1.8, 0.35),
    (0.4, 0.4, 0.3, 0.20),
]


def resolve_run_params(base_gpo, base_gpe, base_tgpe, k, seed):
    if k == 0:
        return base_gpo, base_gpe, base_tgpe, 0, 0.0
    gpo_s, gpe_s, tgpe_s, noise = RUN_PARAMS[k % len(RUN_PARAMS)]
    return (np.float32(base_gpo * np.float32(gpo_s)),
            np.float32(base_gpe * np.float32(gpe_s)),
            np.float32(base_tgpe * np.float32(tgpe_s)),
            seed + k, noise)


def _align_one_run(msa: Msa, k: int, base, seed, n_threads, type_, refine,
                   dist_scale, vsm_amax, realign, use_seq_weights,
                   consistency_anchors, consistency_weight, engine,
                   device=None, autoroute=True) -> Msa:
    """Run k: its penalties, and its tree noise unless it realigns; an
    alignment of its own record."""
    base_gpo, base_gpe, base_tgpe = base
    run_gpo, run_gpe, run_tgpe, run_seed, run_noise = resolve_run_params(
        base_gpo, base_gpe, base_tgpe, k, seed)
    copy = msa.copy()
    copy.quiet = True
    if realign > 0:
        run_seed, run_noise = 0, 0.0
    with recording(fresh=True) as rec:
        out = E.align_msa(copy, n_threads=n_threads, type_=type_,
                          gpo=run_gpo, gpe=run_gpe, tgpe=run_tgpe,
                          refine=refine, tree_seed=run_seed,
                          tree_noise=run_noise, dist_scale=dist_scale,
                          vsm_amax=vsm_amax, realign=realign,
                          use_seq_weights=use_seq_weights,
                          consistency_anchors=consistency_anchors,
                          consistency_weight=consistency_weight,
                          engine=engine, device=device, autoroute=autoroute)
    rec.attach(out)
    return out


def _base_penalties(msa: Msa, type_, gpo, gpe, tgpe, n_threads):
    msa.essential_input_check()
    if msa.biotype == 2:
        msa.detect_alphabet()
    base_ap = P.aln_param_init(msa.biotype, type_, gpo, gpe, tgpe, n_threads)
    return base_ap.gpo, base_ap.gpe, base_ap.tgpe


def ensemble_run_subset(msa: Msa, run_ids, n_threads=1, type_=0,
                        gpo=-1.0, gpe=-1.0, tgpe=-1.0, seed=42,
                        refine=P.REFINE_NONE, dist_scale=0.0, vsm_amax=-1.0,
                        realign=0, use_seq_weights=0.0,
                        consistency_anchors=0, consistency_weight=2.0,
                        engine="gpu-fast", device=None, autoroute=True,
                        runs=None):
    """Align a subset of ensemble runs (the distributed unit of work).

    Runs are embarrassingly parallel: run k's parameters depend only on
    (k, seed) (resolve_run_params), so any partition of 0..n_runs-1
    across processes reproduces the sequential ensemble bit-exactly.
    Returns (partial PoarTable with each run's support bit set at its
    GLOBAL index, {k: aligned row strings}).  The runs and the POAR
    extraction are spans of the record under way, ``runs`` collects each
    run's aligned Msa."""
    base = _base_penalties(msa, type_, gpo, gpe, tgpe, n_threads)
    poar = PoarTable(msa.numseq)
    rows_by_k = {}
    with recording() as rec:
        for k in run_ids:
            with rec.span("runs") as sp:
                aligned = _align_one_run(msa, k, base, seed, n_threads,
                                         type_, refine, dist_scale,
                                         vsm_amax, realign, use_seq_weights,
                                         consistency_anchors,
                                         consistency_weight, engine, device,
                                         autoroute)
                rec.add("runs.realign", sp.start,
                        aligned.phase_times.get("realign", 0.0))
            if runs is not None:
                runs.append(aligned)
            rows = aligned.aligned_rows()
            with rec.span("poar_extract"):
                poar.extract(pos_matrix(rows), k)
            rows_by_k[k] = rows
    return poar, rows_by_k


def ensemble_align(msa: Msa, n_threads: int = 1, type_: int = 0,
                   n_runs: int = 3, gpo: float = -1.0, gpe: float = -1.0,
                   tgpe: float = -1.0, seed: int = 42, min_support: int = 0,
                   save_poar: Optional[str] = None,
                   refine: int = P.REFINE_NONE,
                   dist_scale: float = 0.0, vsm_amax: float = -1.0,
                   realign: int = 0, use_seq_weights: float = -1.0,
                   consistency_anchors: int = 0,
                   consistency_weight: float = 2.0,
                   engine="gpu-fast", device=None,
                   autoroute: bool = True) -> Msa:
    assert n_runs >= 1
    if use_seq_weights < 0.0:
        use_seq_weights = 0.0
    base = _base_penalties(msa, type_, gpo, gpe, tgpe, n_threads)
    runs = []
    with recording() as rec:
        poar, rows_by_k = ensemble_run_subset(
            msa, range(n_runs), n_threads=n_threads, type_=type_, gpo=gpo,
            gpe=gpe, tgpe=tgpe, seed=seed, refine=refine,
            dist_scale=dist_scale, vsm_amax=vsm_amax, realign=realign,
            use_seq_weights=use_seq_weights,
            consistency_anchors=consistency_anchors,
            consistency_weight=consistency_weight, engine=engine,
            device=device, autoroute=autoroute, runs=runs)

        # score each run: prefer run 0 unless >5% improvement
        # (ensemble.c:116-124)
        with rec.span("poar_score"):
            scores = [poar.score_alignment(pos_matrix(rows_by_k[k]))
                      for k in range(n_runs)]
        out = _ensemble_finalize(
            msa, poar, rows_by_k, scores, base, seed, n_threads, type_,
            min_support, save_poar, dist_scale, vsm_amax, use_seq_weights,
            consistency_anchors, consistency_weight, engine, device,
            autoroute, rec)
    rec.attach(out)
    out.engine_stats["ensemble"]["run_engines"] = [
        r.engine_stats["engine"] for r in runs]
    return out


def _ensemble_finalize(msa: Msa, poar: PoarTable, rows_by_k, scores,
                       base, seed, n_threads, type_, min_support,
                       save_poar, dist_scale, vsm_amax, use_seq_weights,
                       consistency_anchors, consistency_weight,
                       engine, device, autoroute, rec) -> Msa:
    """Selection / consensus / post-refinement over the merged POAR
    table and the full set of run alignments (ensemble.c:84-466); the
    stages are spans of the record ``rec``."""
    n_runs = len(scores)
    best_k = 0
    baseline = scores[0]
    for k in range(1, n_runs):
        if scores[k] > scores[best_k] and scores[k] > baseline * 1.05:
            best_k = k

    if save_poar:
        poar.write(save_poar)

    ungapped = [a.replace("-", "") for a in rows_by_k[0]]

    use_consensus = False
    consensus_rows = None
    consensus_score = refined_score = None
    if min_support > 0:
        with rec.span("consensus"):
            consensus_rows = build_consensus(poar, ungapped, min_support)
        use_consensus = True
    else:
        min_sup = max(2, (n_runs + 2) // 3)
        with rec.span("consensus"):
            consensus_rows = build_consensus(poar, ungapped, min_sup)
        with rec.span("poar_score"):
            consensus_score = poar.score_alignment(
                pos_matrix(consensus_rows))
        if consensus_score > scores[best_k]:
            use_consensus = True
        else:
            consensus_rows = None

    winner_rows = rows_by_k[best_k]
    if not use_consensus:
        # post-selection refinement with REFINE_CONFIDENT (ensemble.c:403-451)
        with rec.span("post_selection"):
            refined = _align_one_run(msa, best_k, base, seed, n_threads,
                                     type_, P.REFINE_CONFIDENT, dist_scale,
                                     vsm_amax, 0, use_seq_weights,
                                     consistency_anchors,
                                     consistency_weight, engine, device,
                                     autoroute)
        with rec.span("poar_score"):
            refined_score = poar.score_alignment(
                pos_matrix(refined.aligned_rows()))
        if refined_score > scores[best_k]:
            winner_rows = refined.aligned_rows()

    # install winner into the input msa (original input order preserved:
    # each run's result was rank-restored)
    if use_consensus:
        winner_rows = consensus_rows
    for sq, row in zip(msa.sequences, winner_rows):
        sq.seq = row
    msa.alnlen = len(winner_rows[0])
    msa.aligned = 3  # FINAL

    with rec.span("confidence"):
        conf, col_conf = residue_confidence(poar, winner_rows)
    for i, sq in enumerate(msa.sequences):
        sq.confidence = conf[i].tolist()
    msa.col_confidence = col_conf
    msa.engine_stats = {"ensemble": dict(
        scores=[float(x) for x in scores], best_run=best_k,
        winner="consensus" if use_consensus else "selection",
        consensus_score=consensus_score, refined_score=refined_score)}
    return msa


def ensemble_worker(msa: Msa, worker: int, workers: int, scratch: str,
                    n_runs: int = 3, **kwargs) -> List[int]:
    """Distributed ensemble, map phase: align this worker's share of the
    runs (k % workers == worker) and persist the partial POAR table and
    per-run aligned rows into `scratch`.  Any process/host can run any
    worker id; results are bit-identical to the sequential ensemble.
    kwargs are forwarded to ensemble_run_subset."""
    os.makedirs(scratch, exist_ok=True)
    run_ids = [k for k in range(n_runs) if k % workers == worker]
    poar, rows_by_k = ensemble_run_subset(msa, run_ids, **kwargs)
    poar.write(os.path.join(scratch, f"poar.w{worker}.bin"))
    for k, rows in rows_by_k.items():
        with open(os.path.join(scratch, f"run{k:03d}.rows.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return run_ids


def ensemble_merge(msa: Msa, scratch: str, n_runs: int = 3,
                   n_threads: int = 1, type_: int = 0,
                   gpo: float = -1.0, gpe: float = -1.0, tgpe: float = -1.0,
                   seed: int = 42, min_support: int = 0,
                   save_poar: Optional[str] = None,
                   dist_scale: float = 0.0, vsm_amax: float = -1.0,
                   use_seq_weights: float = 0.0,
                   consistency_anchors: int = 0,
                   consistency_weight: float = 2.0,
                   engine="gpu-fast", device=None,
                   autoroute: bool = True) -> Msa:
    """Distributed ensemble, reduce phase: OR-merge the workers' partial
    POAR tables, reload every run's alignment, then run the sequential
    selection / consensus / refinement logic."""
    base = _base_penalties(msa, type_, gpo, gpe, tgpe, n_threads)
    parts = sorted(glob.glob(os.path.join(scratch, "poar.w*.bin")))
    if not parts:
        raise FileNotFoundError(f"no partial POAR tables in {scratch}")
    poar = merge_poar_tables([PoarTable.read(p) for p in parts])
    poar.n_alignments = n_runs

    rows_by_k = {}
    for k in range(n_runs):
        path = os.path.join(scratch, f"run{k:03d}.rows.txt")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"run {k} missing from {scratch} (incomplete workers?)")
        with open(path) as f:
            rows_by_k[k] = f.read().splitlines()
    scores = [poar.score_alignment(pos_matrix(rows_by_k[k]))
              for k in range(n_runs)]
    with recording() as rec:
        out = _ensemble_finalize(
            msa, poar, rows_by_k, scores, base, seed, n_threads, type_,
            min_support, save_poar, dist_scale, vsm_amax, use_seq_weights,
            consistency_anchors, consistency_weight, engine, device,
            autoroute, rec)
    rec.attach(out)
    return out


def consensus_from_poar(msa: Msa, poar_path: str, min_support: int) -> Msa:
    """Re-threshold a saved POAR table without re-aligning
    (kalign_consensus_from_poar, ensemble.c:500-543)."""
    msa.essential_input_check()
    poar = PoarTable.read(poar_path)
    if poar.numseq != msa.numseq:
        raise ValueError(f"POAR file has {poar.numseq} sequences, "
                         f"input has {msa.numseq}")
    ungapped = [sq.seq.replace("-", "") for sq in msa.sequences]
    rows = build_consensus(poar, ungapped, min_support)
    for sq, row in zip(msa.sequences, rows):
        sq.seq = row
    msa.alnlen = len(rows[0])
    msa.aligned = 3
    conf, col_conf = residue_confidence(poar, rows)
    for i, sq in enumerate(msa.sequences):
        sq.confidence = conf[i].tolist()
    msa.col_confidence = col_conf
    return msa
