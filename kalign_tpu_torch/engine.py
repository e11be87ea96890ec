"""Pipeline driver: ties the data model to the GPU engine.

Counterpart of kalign_tpu/engine.py (align_msa :281-434,
post_realign_msa :437-508) and so of the reference's kalign_run_seeded /
kalign_run_realign / kalign_post_realign (lib/src/aln_wrap.c:133-669):

  input check -> dealign -> sort len/name -> encode reduced -> anchors
  -> anchor distances [-> tree noise] -> guide tree (native, or the
  device k-means tree from 2,048 sequences on the card; or both resumed
  from a checkpoint) -> encode full -> params -> consistency maps
  (default mode) -> progressive align (with refinement candidates when
  asked) -> [realign: identity distances -> UPGMA tree -> progressive
  align, per iteration] -> finalise -> restore rank order

Engines (kalign_tpu's "tpu-fast", "tpu", "tpu-mesh" and "host"):
  * "gpu-fast" (gpu/engine.py): hand-written CUDA kernels on the card,
    level-batched merges and map DPs; score-optimal per merge, may differ
    from the reference's Hirschberg midpoints on near-ties.  Divergent
    families (mean anchor distance above 0.5, up to ``autoroute_max``
    sequences) switch to "gpu" after the guide tree, as kalign_tpu's
    tpu-fast switches to its exact engine (kalign_tpu/engine.py:345-364);
  * "gpu": bit-exact — the native runtime orchestrates and every
    Hirschberg DP runs its O(L^2) sweeps on the card (gpu/exact.py, the
    wavefront kernel csrc/exact_sweep.cu); gives the "host" bytes;
  * "gpu-mesh": "gpu-fast" with the anchor distances and the merge
    buckets sharded over every visible card, of every process after
    parallel.distributed.init_distributed (parallel/mesh.py; pass
    ``mesh=`` to get_engine for another layout, such as shards on one
    card or on the CPU), the host-assembled progressive pass, and merges
    too wide for one block's registers split by columns over the cards
    (on a mesh within one process; across processes such a merge
    raises, as in kalign_tpu); divergent families switch to "gpu" as on
    "gpu-fast";
  * "host": the native C++ runtime alone (native/);
  * "auto": the user's request for kalign_tpu's documented policy
    (resolve_auto_engine), resolved before the engine is built; the
    choice is recorded in engine_stats["engine"].
The entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version
instead; without a card they raise.
"""

import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from kalign_tpu_torch import checkpoint as ckpt
from kalign_tpu_torch import native
from kalign_tpu_torch.core import alphabet as alpha
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.core.msa import (ALN_STATUS_ALIGNED, BIOTYPE_DNA,
                                       BIOTYPE_PROTEIN, Msa)
from kalign_tpu_torch.gpu import distances
from kalign_tpu_torch.gpu.consistency import ConsistencyTable
from kalign_tpu_torch.gpu.engine import GpuEngine
from kalign_tpu_torch.gpu.exact import ExactDpBackend
from kalign_tpu_torch.parallel import mesh as mesh_mod
from kalign_tpu_torch.parallel.distributed import cards_of_every_process
from kalign_tpu_torch.utils.logging import log, recording, took
from kalign_tpu_torch.utils.rng import XoshiroRng
from kalign_tpu_torch.utils.sorting import glibc_msort

ENGINES = P.ENGINES
# engine "auto" takes the native runtime below this many sequences
# (kalign_tpu/engine.py:201)
AUTO_MIN_SEQUENCES = 256
# the divergent-family autoroute (kalign_tpu/engine.py:201-212,345-364):
# mean anchor distance above this, up to AUTOROUTE_MAX sequences
AUTOROUTE_DISTANCE = 0.5
AUTOROUTE_MAX = 16384

# serialises the native DP hooks' install -> align -> uninstall: the hooks
# are process-wide globals, and ctypes releases the GIL during
# kt_align_msa
_HOOK_LOCK = threading.Lock()


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


def resolve_auto_engine(msa: Optional[Msa] = None, device=None) -> str:
    """engine="auto" (kalign_tpu/engine.py::resolve_auto_engine
    :189-204): "host" when the device is not a CUDA card that is there,
    or below AUTO_MIN_SEQUENCES sequences (the native runtime gives the
    exact engines' bytes and is faster on small inputs); "gpu-mesh" when
    the cards of every process (one gather under a process group, as
    len(jax.devices()) counts every process's after jax.distributed)
    number more than one; "gpu-fast" on ``device`` otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "host"
    if msa is not None and msa.numseq < AUTO_MIN_SEQUENCES:
        return "host"
    return "gpu-mesh" if cards_of_every_process() > 1 else "gpu-fast"


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


class HostEngine:
    """Engine "host" (kalign_tpu/engine.py::HostEngine :48): the native
    runtime's anchor distances, guide trees and progressive alignment,
    consistency table and refinement included."""

    name = "host"

    def __init__(self, n_threads: int = 1):
        self.n_threads = n_threads
        self.stats = {"engine": self.name, "tree": "native"}

    def anchor_distances(self, codes, anchors):
        return native.anchor_distances(codes, anchors, self.n_threads)

    def build_tree(self, codes, dm, n_anchors):
        return native.build_tree(codes, dm, n_anchors, counts=self.stats)

    def build_tree_pairwise(self, dm):
        return native.build_tree_pairwise(dm)

    def aln_pairwise_dist(self, rows):
        return native.aln_pairwise_dist(rows)

    def align(self, codes, tasks, ap: P.AlnParam, seq_distances,
              refine_mode: int = P.REFINE_NONE, cons_seq_distances=None):
        """kt_align_msa: (gaps per sequence, per-merge confidences)."""
        flat, off, lens = native.flatten_seqs(codes)
        n = len(codes)
        gaps_out = np.zeros(int(np.sum(lens + 1)), dtype=np.int32)
        conf_out = np.zeros(n - 1, dtype=np.float32)

        def ptr(x):
            if x is None:
                return None, None
            x = np.ascontiguousarray(x, dtype=np.float32)
            return x, x.ctypes.data
        # sd and csd keep the buffers alive during the call
        sd, sd_ptr = ptr(seq_distances)
        csd, csd_ptr = ptr(cons_seq_distances)
        rc = native.lib().kt_align_msa(
            flat, off, lens, n,
            np.ascontiguousarray(tasks.reshape(-1).astype(np.int32)), n - 1,
            np.ascontiguousarray(ap.subm.astype(np.float32).reshape(-1)),
            float(ap.gpo), float(ap.gpe), float(ap.tgpe),
            float(ap.dist_scale), float(ap.vsm_amax),
            float(ap.use_seq_weights), sd_ptr, csd_ptr,
            int(ap.consistency_anchors), float(ap.consistency_weight),
            int(refine_mode), int(ap.adaptive_budget),
            gaps_out, conf_out, self.n_threads)
        if rc != 0:
            raise RuntimeError("native alignment failed")
        bounds = np.cumsum(lens + 1)[:-1]
        return [g.tolist() for g in np.split(gaps_out, bounds)], conf_out


class GpuExactEngine(HostEngine):
    """Engine "gpu" (kalign_tpu/engine.py::ExactTpuEngine :132): the
    native runtime orchestrates (profiles, consistency, refinement, flip
    bookkeeping) and every Hirschberg DP — merges, refinement trials and
    the consistency pre-pass's pairwise maps — runs its sweeps on
    ``device`` through the DP hooks (gpu/exact.py).  Column-identical to
    "host".  The anchor distances run through the BPM kernel on the card
    (the native ones on the CPU: the same bits, faster there); the guide
    tree is the native one.  The canary runs at construction and raises
    on a mismatch.  ``stats`` counts the sweep's launches, grids and
    wavefront steps of the last alignment (``sweep_steps``: per launch,
    the steps of its longest block, gpu/exact.py::Sweeper), and splits
    its host seconds (``exact_split_s``): ``native``, the native runtime
    outside the DP hooks; ``plans``, the hooks' host work (operand
    tables, chunks, plan rows, schedules, decoding the meets, spawning
    the next depth's windows); ``enqueue``, queueing device work
    (gathers, uploads, sweeps, meets); ``fetch``, waiting on each
    depth's fetch."""

    name = "gpu"

    def __init__(self, device, n_threads: int = 1):
        super().__init__(n_threads)
        self.device = torch.device(device)
        self.backend = ExactDpBackend(self.device)
        self.stats["canary"] = self.backend.run_canary()

    def anchor_distances(self, codes, anchors):
        """Native on the CPU; on the card sharded over every visible card
        when there are several (kalign_tpu/engine.py:147-165)."""
        if self.device.type == "cpu":
            return super().anchor_distances(codes, anchors)
        if torch.cuda.device_count() > 1:
            return mesh_mod.anchor_distances(mesh_mod.make_mesh(), codes,
                                             anchors)
        return distances.anchor_distances(codes, anchors, self.device)

    def align(self, codes, tasks, ap: P.AlnParam, seq_distances,
              refine_mode: int = P.REFINE_NONE, cons_seq_distances=None):
        sw, be = self.backend.sweeper, self.backend
        before = (sw.launches, sw.grids, sw.steps, be.calls)
        secs = (be.hook_s, sw.enqueue_s, sw.fetch_s)
        t0 = time.perf_counter()
        with _HOOK_LOCK:
            self.backend.install()
            try:
                return super().align(codes, tasks, ap, seq_distances,
                                     refine_mode, cons_seq_distances)
            except RuntimeError as e:
                if self.backend.last_error:
                    raise RuntimeError("device DP backend failed:\n"
                                       + self.backend.last_error) from e
                raise
            finally:
                self.backend.uninstall()
                wall = time.perf_counter() - t0
                after = (sw.launches, sw.grids, sw.steps, be.calls)
                for key, a, b in zip(("sweep_launches", "sweep_grids",
                                      "sweep_steps", "hook_calls"),
                                     after, before):
                    self.stats[key] = a - b
                hook, enq, fetch = (a - b for a, b in zip(
                    (be.hook_s, sw.enqueue_s, sw.fetch_s), secs))
                self.stats["exact_split_s"] = dict(
                    native=wall - hook, plans=hook - enq - fetch,
                    enqueue=enq, fetch=fetch)


def get_engine(name="gpu-fast", device=None, n_threads: int = 1,
               msa: Optional[Msa] = None, mesh=None):
    """The engine of a name of ENGINES, on ``device`` ("auto" resolved
    on msa, resolve_auto_engine); an engine object passed as the name is
    used as it is (``GpuEngine(device, resident=False)`` runs the
    host-assembled progressive pass).  n_threads goes to the native
    runtime of "host" and "gpu".  "gpu-mesh" runs on ``mesh``, by default
    make_mesh() over every visible card (kalign_tpu/engine.py:221-240;
    without a card it raises)."""
    if isinstance(name, (GpuEngine, HostEngine)):
        return name
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r} (have {ENGINES})")
    if name == "auto":
        name = resolve_auto_engine(msa, device)
    if name == "host":
        return HostEngine(n_threads)
    if name == "gpu":
        return GpuExactEngine(resolve_device(device), n_threads)
    if name == "gpu-mesh":
        return GpuEngine(mesh=mesh_mod.make_mesh() if mesh is None else mesh)
    return GpuEngine(resolve_device(device))


def _encoded(msa: Msa, kind: int):
    msa.encode(kind)
    return [sq.s for sq in msa.sequences]


def resolve_params(msa: Msa, type_: int, gpo: float, gpe: float,
                   tgpe: float, n_threads: int) -> P.AlnParam:
    type_ = P.resolve_pfasum_auto(type_, msa.biotype,
                                  [sq.len for sq in msa.sequences])
    return P.aln_param_init(msa.biotype, type_, gpo, gpe, tgpe, n_threads)


def perturb_distances(dm: np.ndarray, n_anchors: int, rng: XoshiroRng,
                      sigma: float) -> None:
    """Ensemble tree noise (kalign_tpu/engine.py::_build_guide_tree
    :258-266, bisectingKmeans.c:104-116): each (sequence, anchor)
    distance times a gaussian factor N(1, sigma) clamped at 0.1, drawn
    row-major, one float32 multiply each; in place."""
    noise = np.empty((dm.shape[0], n_anchors), np.float32)
    for i in range(dm.shape[0]):
        for j in range(n_anchors):
            g = rng.gaussian(1.0, float(sigma))
            noise[i, j] = 0.1 if g < 0.1 else g
    dm[:, :n_anchors] *= noise


def _pass_refine(refine: int, last: bool) -> int:
    """A pass's refinement (kalign_tpu/engine.py:386-402, aln_wrap.c:
    440-509): inline in every pass, ALL / CONFIDENT in the last one only."""
    if refine == P.REFINE_INLINE or last:
        return refine
    return P.REFINE_NONE


def _align_pass(msa: Msa, eng, codes, tasks, ap: P.AlnParam, ct,
                cons_seq_distances, refine_mode: int):
    """One progressive pass of eng over codes on msa.seq_distances' tree
    weights, its gaps set on msa; returns the per-merge scores.  A
    GpuEngine takes the consistency table ct; the native runtime builds
    its own inside kt_align_msa from cons_seq_distances."""
    if isinstance(eng, GpuEngine):
        eng.set_alphabet(codes, ap.subm)
        gaps, conf = eng.align(codes, tasks, ap, msa.seq_distances, ct,
                               refine_mode=refine_mode)
    else:
        gaps, conf = eng.align(codes, tasks, ap, msa.seq_distances,
                               refine_mode=refine_mode,
                               cons_seq_distances=cons_seq_distances)
    for sq, g in zip(msa.sequences, gaps):
        sq.gaps = g
    msa.aligned = ALN_STATUS_ALIGNED
    return conf


def _realign_tree(msa: Msa, eng):
    """One realign iteration's guide tree (kalign_tpu/engine.py:408-420):
    identity distances of the finalised alignment, the sequences
    stripped and encoded again, UPGMA over those distances.  Returns
    (codes, tasks); msa.seq_distances takes the tree's distances."""
    if msa.aligned != 3:  # not FINAL yet
        msa.finalise()
    dm = eng.aln_pairwise_dist(msa.aligned_rows())
    msa.strip_gaps()
    codes = _encoded(msa, alpha.ALPHA_DEFAULT_DNA
                     if msa.biotype == BIOTYPE_DNA
                     else alpha.ALPHA_AMBIGUOUS_PROTEIN)
    msa.set_sip_nsip()
    tasks, seq_dist = eng.build_tree_pairwise(dm)
    msa.seq_distances = seq_dist
    return codes, tasks


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
              device=None, autoroute: bool = True,
              autoroute_max: int = AUTOROUTE_MAX) -> Msa:
    """Full alignment pipeline: default mode with consistency_anchors > 0
    (the reference's default is 5), --fast mode with 0; refine one of
    P.REFINE_NONE, REFINE_ALL, REFINE_CONFIDENT, REFINE_INLINE.
    ``engine`` is a name of ENGINES or an engine object (get_engine).
    With ``autoroute`` (kalign_tpu's KALIGN_TPU_NO_AUTOROUTE unset), a
    "gpu-fast" run of at most ``autoroute_max`` sequences
    (KALIGN_TPU_AUTOROUTE_MAX) whose mean anchor distance exceeds 0.5
    aligns with "gpu" on the same device, keeping the tree already
    built.  engine_stats["engine"] names the engine that aligned.

    tree_noise > 0 with tree_seed != 0 perturbs the anchor distances
    before the tree (perturb_distances; without a seed no noise, as in
    the reference).  save_checkpoint=DIR writes the guide tree and the
    distances (checkpoint.py, kalign_tpu's format); resume_checkpoint=DIR
    reads them in place of the distances and the tree.  realign=R runs R
    more passes, each on a UPGMA tree of the previous alignment's
    identity distances; the consistency maps stay those of the BPM
    distances, and refine ALL / CONFIDENT applies to the last pass only
    (inline to every pass).  engine="auto" resolves on this input
    (resolve_auto_engine).

    The stages are spans (utils/logging.py) of the record the thread has
    open, or of a new one: "input" (the checks, dealigning, sorting, the
    encodings, the anchors, the engine, the autoroute, the checkpoint
    and the parameters), "distances", "tree", "consistency",
    "progressive", "realign" per pass and "output" (finalise, the input
    order); msa.spans holds them and msa.phase_times their seconds."""
    with recording() as rec:
        with rec.span("input"):
            eng = get_engine(engine, device, n_threads, msa)
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
            if resume_checkpoint is not None:
                tasks = ckpt.read_tasks(os.path.join(resume_checkpoint,
                                                     "tasks.txt"))
                _, seq_dist, _ = ckpt.load_distances(
                    os.path.join(resume_checkpoint, "distances.npz"),
                    expect_fingerprint=ckpt.input_fingerprint(
                        [sq.seq for sq in msa.sequences]))
                if len(tasks) != msa.numseq - 1 \
                        or len(seq_dist) != msa.numseq:
                    raise ValueError("checkpoint does not match the input "
                                     f"(expected {msa.numseq} sequences)")
                log("Resumed distances + guide tree from checkpoint", quiet)
            else:
                anchors = pick_anchors(msa)
                codes = [sq.s for sq in msa.sequences]
        if resume_checkpoint is None:
            log("Calculating pairwise distances", quiet)
            with rec.span("distances") as d:
                dm = eng.anchor_distances(codes, anchors)
                if tree_seed != 0 and tree_noise > 0.0:
                    perturb_distances(dm, len(anchors),
                                      XoshiroRng(tree_seed), tree_noise)
            with rec.span("tree") as t:
                tasks, seq_dist = eng.build_tree(codes, dm, len(anchors))
            took("Distances + guide tree", d.seconds + t.seconds, quiet)
        # the rest of the input's preparation: the autoroute, the
        # checkpoint, the full alphabet and the scoring parameters
        with rec.span("input"):
            msa.seq_distances = seq_dist
            # Divergent-family autoroute (kalign_tpu/engine.py:345-364):
            # the throughput engine's tie-breaking loses column accuracy
            # where alignment is hardest (BB30014: TC 0.45 against the
            # exact engine's 0.47), so such families take the bit-exact
            # engine
            if autoroute and isinstance(eng, GpuEngine) \
                    and msa.numseq <= autoroute_max:
                mean_sd = float(np.mean(np.asarray(seq_dist, np.float64)))
                if mean_sd > AUTOROUTE_DISTANCE:
                    log(f"Divergent family (mean distance {mean_sd:.2f}): "
                        "using the exact engine", quiet)
                    tree_stats = eng.stats
                    eng = GpuExactEngine(eng.device, n_threads)
                    eng.stats.update(
                        tree=tree_stats["tree"],
                        tree_s=tree_stats.get("tree_s"),
                        routed_from=tree_stats["engine"],
                        mean_seq_distance=mean_sd,
                        **{k: tree_stats[k] for k in (
                            *native.TREE_COUNTS, "tree_pairs_batched")
                           if k in tree_stats})
            if save_checkpoint is not None:
                os.makedirs(save_checkpoint, exist_ok=True)
                ckpt.write_tasks(tasks, os.path.join(save_checkpoint,
                                                     "tasks.txt"))
                ckpt.save_distances(
                    os.path.join(save_checkpoint, "distances.npz"),
                    np.zeros((0, 0), np.float32), seq_dist,
                    fingerprint=ckpt.input_fingerprint(
                        [sq.seq for sq in msa.sequences]))

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

            # the anchors of the consistency maps stay the BPM distances'
            # in every pass (kalign_tpu/engine.py:403)
            bpm_seq_dist = msa.seq_distances
            codes = [sq.s for sq in msa.sequences]
        ct = None
        if isinstance(eng, GpuEngine) and ap.consistency_anchors > 0:
            # kalign_tpu's TpuEngine.align builds this table in every pass
            # from the same codes and distances; built once here, since a
            # realign pass's codes are the first pass's
            # (tests/test_torch_realign.py holds the two tables equal)
            with rec.span("consistency"):
                eng.set_alphabet(codes, ap.subm)
                ct = ConsistencyTable.build(eng, codes, ap, bpm_seq_dist,
                                            ap.consistency_anchors,
                                            ap.consistency_weight)

        log("Aligning", quiet)
        # (on "host" and "gpu", "progressive" covers the native runtime's
        # consistency table)
        with rec.span("progressive") as p:
            conf = _align_pass(msa, eng, codes, tasks, ap, ct, bpm_seq_dist,
                               _pass_refine(refine, realign == 0))
        took("Alignment", p.seconds, quiet)
        for it in range(realign):
            with rec.span("realign"):
                codes, tasks = _realign_tree(msa, eng)
                conf = _align_pass(msa, eng, codes, tasks, ap, ct,
                                   bpm_seq_dist,
                                   _pass_refine(refine, it == realign - 1))

        with rec.span("output"):
            msa.finalise()
            msa.sort_rank()
        msa.task_confidence = conf
        msa.engine_stats = eng.stats
    rec.attach(msa)
    return msa


def post_realign_msa(msa: Msa, n_threads: int = 1, type_: int = 0,
                     gpo: float = -1.0, gpe: float = -1.0,
                     tgpe: float = -1.0, refine: int = P.REFINE_NONE,
                     adaptive_budget: int = 0, dist_scale: float = 0.0,
                     vsm_amax: float = -1.0, realign_iterations: int = 1,
                     use_seq_weights: float = -1.0, engine="gpu-fast",
                     device=None) -> Msa:
    """Realign an existing alignment (kalign_tpu/engine.py::
    post_realign_msa :437-508, kalign_post_realign, aln_wrap.c:539-669):
    each iteration a UPGMA tree of the alignment's identity distances and
    a progressive pass, with no anchor consistency.  The input must be
    aligned, its rows of one width; the rows are not sorted, and their
    input order comes back at the end.  ``engine`` and ``device`` as
    align_msa takes them (no autoroute); the spans "input", "realign" and
    "output" as align_msa records them."""
    if realign_iterations < 1:
        raise ValueError("Need at least 1 realign iteration")
    if msa.aligned not in (2, 3):  # ALIGNED or FINAL
        raise ValueError("post_realign requires an aligned MSA")
    widths = {sq.len + sum(sq.gaps) for sq in msa.sequences}
    if len(widths) > 1:  # UNKNOWN shares FINAL's value in the reference
        raise ValueError(
            "post_realign requires equal-length aligned rows "
            f"(got widths {sorted(widths)})")
    with recording() as rec:
        with rec.span("input"):
            eng = get_engine(engine, device, n_threads, msa)
            quiet = msa.quiet
            if msa.biotype == 2:  # BIOTYPE_UNDEF
                msa.detect_alphabet()
            ap = resolve_params(msa, type_, gpo, gpe, tgpe, n_threads)
            ap.adaptive_budget = adaptive_budget
            if use_seq_weights >= 0.0:
                ap.use_seq_weights = use_seq_weights
            ap.dist_scale = dist_scale
            if vsm_amax >= 0.0:
                ap.vsm_amax = vsm_amax

        log("Post-realign (%d iterations, vsm_amax=%.2f)"
            % (realign_iterations, ap.vsm_amax), quiet)
        conf = None
        with rec.span("realign") as r:
            for it in range(realign_iterations):
                codes, tasks = _realign_tree(msa, eng)
                conf = _align_pass(msa, eng, codes, tasks, ap, None,
                                   msa.seq_distances, _pass_refine(
                                       refine, it == realign_iterations - 1))
        took("Post-realign", r.seconds, quiet)

        with rec.span("output"):
            msa.finalise()
            msa.sort_rank()
        msa.task_confidence = conf
        msa.engine_stats = eng.stats
    rec.attach(msa)
    return msa
