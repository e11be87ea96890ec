"""GPU engine: progressive MSA with the DP on the card.

Counterpart of kalign_tpu/tpu/engine.py::TpuEngine in its single-device
form:

  * anchor distances: the BPM kernel (gpu/distances.py);
  * guide tree: the native builder (native/) below DEVICE_TREE_MIN_SEQS
    sequences or on the CPU, its leaf sets' pair distances in one batch
    on the BPM kernel (gpu/distances.py::leaf_distances), else the device
    k-means tree (gpu/kmeans.py, the Lloyd kernel);
  * consistency maps (default mode): N x K leaf-against-anchor DPs whose
    operands are assembled on the card from a token table uploaded once
    (``dp_leaf_batch``); only index vectors travel per launch;
  * progressive pass: level-synchronous — all merges of one guide-tree
    level are independent, so they are bucketed by padded shape and each
    bucket runs as one batch (``launch_bucket``): an fp32 ``torch.bmm``
    for the match scores (plus the consistency bonus, built on the card
    from compact arrays), the row Gotoh kernel, or for buckets of
    k * 1024 problems the problem-per-lane kernel, and the traceback walk
    on the card.  Bonus-free batches over a narrow alphabet (DNA) skip
    the match product: the fused kernel computes the match from the
    operands.  By default the pass is device-resident (gpu/resident.py:
    profiles, gap lists and bonus arrays stay on the device, one fetch
    per level); ``GpuEngine(device, resident=False)`` runs the
    host-assembled pass (``host_pass``: buckets assembled in numpy, step
    lists fetched per bucket, profile merge and gap weave in numpy,
    gpu/profile.py), the resident pass's oracle;
  * refinement (``align``'s refine_mode): K candidate DPs per merge, one
    per centering-bias strength, the path of the best expected
    sum-of-pairs kept.

Every kernel wrapper runs its plain PyTorch version when the engine's
device is the CPU; the routing is the same on both devices.

Contract: the same pipeline semantics as the host engine; alignments are
score-optimal per merge and may differ from other engines on near-ties.
"""

from typing import List, Optional

import numpy as np
import torch

from kalign_tpu_torch import native
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.gpu import (distances, gotoh_fused, gotoh_lanewise,
                                  gotoh_row, gotoh_wave, kmeans)
from kalign_tpu_torch.gpu import traceback as tb
# bonus_match (prepare_match's plain version) is importable from here too
from kalign_tpu_torch.gpu.prepare import bonus_match, prepare_match
from kalign_tpu_torch.gpu.profile import (Profile, column_gap_counts,
                                          leaf_profile, merge_profiles,
                                          sp_score_from_profiles,
                                          weave_steps)
from kalign_tpu_torch.utils.logging import recording, span


def _bucket(n: int, q: int = 128) -> int:
    return max(q, ((n + q - 1) // q) * q)


def _pow2_batch(B: int) -> int:
    """Launch batches are powers of two (min 8), as in the TPU engine, so
    the two engines bucket and route merges alike."""
    p = 8
    while p < B:
        p *= 2
    return p


def level_buckets(buckets) -> dict:
    """A level's bucket sizes for stats["levels"], keyed "L1pxL2p", with
    "/K" for a bucket of K > 1 candidates."""
    out = {}
    for (L1p, L2p, cands), items in buckets.items():
        key = f"{L1p}x{L2p}" + (f"/{len(cands)}" if len(cands) > 1 else "")
        out[key] = out.get(key, 0) + len(items)
    return out


def terminal_mask(steps: np.ndarray) -> np.ndarray:
    n = len(steps)
    term = np.zeros(n, dtype=bool)
    i = 0
    while i < n and steps[i] != 0:
        term[i] = True
        i += 1
    i = n - 1
    while i >= 0 and steps[i] != 0:
        term[i] = True
        i -= 1
    return term


# ---------------------------------------------------------------------------
# Routing rules, copied from the JAX engine for near-tie parity: the
# lanewise and fused DPs round the in-row gap state otherwise than the row
# kernel's scan transform, so a bucket must take the DP that kalign_tpu
# gives it, or near-tie paths differ.  The arithmetic is the TPU kernels'
# VMEM plan (lanewise_vmem_bytes, lanewise_plan, fused_vmem_bytes,
# fused_plan, kalign_tpu/tpu/gotoh_lanewise.py:78-129,474-522): a rule of
# the reference, not a limit of this card.
_VMEM_BUDGET = 11 * 2 ** 20
_TILE_BYTES = 8 * 128 * 4           # one [8, 128] float32 vector tile
_TPU_PACK = 4                       # the TPU kernels' decisions per int32


def _stream_tiles(L2p: int, R: int, L2t: int, ncp: int = 4) -> int:
    """Tiles of the streams both plans share (state, penalties, ga0,
    decisions, row penalties, boundary and pads)."""
    return (3 * L2p + 2 * ncp * L2t + 2 * L2t + 2 * R * (L2t // _TPU_PACK)
            + 2 * R * 7 + (3 * (R + 1) + 1) + 8)


def lanewise_vmem_bytes(L2p: int, R: int, L2t: int) -> int:
    return (_stream_tiles(L2p, R, L2t) + 2 * R * L2t) * _TILE_BYTES


def fused_vmem_bytes(L2p: int, nc: int, R: int, L2t: int) -> int:
    return (_stream_tiles(L2p, R, L2t) + 2 * R * nc
            + 2 * nc * L2t) * _TILE_BYTES


def _plan_fits(B: int, L1p: int, L2p: int, rows, vmem) -> bool:
    """A (rows per step, column tile) plan exists within the budget."""
    if B % gotoh_lanewise.BT or B < gotoh_lanewise.BT or L2p % _TPU_PACK:
        return False
    tiles = [L2p // ct for ct in range(1, 9)
             if L2p % ct == 0 and (L2p // ct) % _TPU_PACK == 0]
    return any(vmem(R, L2t) <= _VMEM_BUDGET
               for R in rows if L1p % R == 0 for L2t in tiles)


def lanewise_feasible(B: int, L1p: int, L2p: int) -> bool:
    return _plan_fits(B, L1p, L2p, (4, 8, 2, 1),
                      lambda R, L2t: lanewise_vmem_bytes(L2p, R, L2t))


def fused_feasible(B: int, L1p: int, L2p: int, nc: int) -> bool:
    return _plan_fits(B, L1p, L2p, (8, 4, 16, 2, 1),
                      lambda R, L2t: fused_vmem_bytes(L2p, nc, R, L2t))


# ---------------------------------------------------------------------------
def bucket_match(lhs, rhs, la, lb, eps, bonus):
    """A launch batch's fp32 match product and the (slope, eps) of the
    centering bias its DP kernel subtracts: with a bonus, the bias and the
    bonus are added to the match in place (prepare.prepare_match: the
    kernel on the card, bonus_match on the CPU) and the kernel adds
    none."""
    slope = lb.to(torch.float32) / torch.clamp(la.to(torch.float32), min=1.0)
    match = torch.bmm(lhs, rhs.transpose(1, 2))       # fp32
    if bonus is None:
        return match, slope, eps
    return (prepare_match(match, la, lb, eps, bonus), torch.zeros_like(slope),
            torch.zeros_like(eps))


def card_bytes(device):
    """Device bytes a launch can still take on a card: free memory and
    what torch's caching allocator holds unused; None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))


def problem_bytes(L1p: int, L2p: int) -> int:
    """Device bytes one problem of L1p x L2p takes on the row routes: its
    decisions (int8) and its match (float32; on the wave route one block
    of rows), the state and strips of the wave route."""
    L1p, L2p = int(L1p), int(L2p)
    if gotoh_row.launch_config(1, L2p).route == "wave":
        return gotoh_wave.problem_bytes(L1p, L2p)
    return 5 * L1p * L2p


def check_fits(device, L1p: int, L2p: int) -> None:
    """The memory guard of the wide routes: raises, naming the width,
    where the card cannot hold one problem."""
    have = card_bytes(device)
    need = problem_bytes(L1p, L2p)
    if have is not None and need > have:
        raise MemoryError(
            f"a {L1p} x {L2p} DP needs {need / 2 ** 30:.1f} GiB of device "
            f"memory (decisions, match rows, state); {device} has "
            f"{have / 2 ** 30:.1f} GiB free")


def row_route(lhs, rhs, pc, pr, la, lb, eps, bonus, la_h=None):
    """One launch batch through the row kernel (tpu/engine.py:441-491 at
    the row plan): bucket_match, the forward and the walk; past 114,688
    columns the wave route from the operands, one block of rows at a time
    (gotoh_wave.forward_operands; la_h, the host lengths, sets how many
    rows it launches).  A wide route first checks that one problem fits
    the card.  Returns (steps, n, score) on the tensors' device."""
    L1p, L2p = lhs.shape[1], rhs.shape[1]
    route = gotoh_row.launch_config(lhs.shape[0], L2p).route
    if route != "row":
        check_fits(lhs.device, L1p, L2p)
    if route == "wave":
        dec, score, st = gotoh_wave.forward_operands(
            lhs, rhs, pc, pr, la, lb, eps, bonus, la_h)
    else:
        match, slope, eps = bucket_match(lhs, rhs, la, lb, eps, bonus)
        dec, score, st = gotoh_row.forward(match, pc, pr, la, lb, slope, eps)
    steps, n = tb.walk_rows(dec, la, lb, st, L1p + L2p + 2)
    return steps, n, score


def pad_batch(lhs, rhs, pc, pr, la, lb, eps, bonus, pad: int):
    """A launch batch of host arrays and pad more problems: 8 x 8 with the
    last problem's penalties, eps 0 and no bonus (tpu/engine.py:
    424-437)."""
    if not pad:
        return lhs, rhs, pc, pr, la, lb, eps, bonus

    def padn(x, fill=0):
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
    if bonus is not None:
        bonus = (bonus[0], padn(bonus[1], -1), padn(bonus[2]),
                 padn(bonus[3], -1), padn(bonus[4]))
    return (padn(lhs), padn(rhs), np.concatenate([pc, np.repeat(
        pc[-1:], pad, axis=0)]), np.concatenate([pr, np.repeat(
            pr[-1:], pad, axis=0)]), padn(la, 8), padn(lb, 8), padn(eps),
            bonus)


def leaf_operands(tok, subm, penv, rows, cols, la, lb, L1p: int, L2p: int):
    """Leaf-against-leaf operands assembled on the tensors' device from
    the token table (kalign_tpu/tpu/engine.py::_leaf_assemble :182-211):
    one-hot counts on the rows, substitution rows on the columns, and the
    constant penalties masked to each problem's lengths."""
    B = rows.shape[0]
    dev = tok.device
    f32 = dict(dtype=torch.float32, device=dev)
    Lt = tok.shape[1]
    Lr, Lc = min(L1p, Lt), min(L2p, Lt)
    rt = tok[rows.long()][:, :Lr]
    ct = tok[cols.long()][:, :Lc]
    valid_r = (torch.arange(Lr, device=dev)[None, :] < la[:, None])[:, :, None]
    valid_c = (torch.arange(Lc, device=dev)[None, :] < lb[:, None])[:, :, None]
    alpha = torch.arange(23, device=dev).to(tok.dtype)
    lhs = torch.zeros((B, L1p, 23), **f32)
    lhs[:, :Lr] = ((rt[:, :, None] == alpha[None, None, :])
                   & valid_r).to(torch.float32)
    rhs = torch.zeros((B, L2p, 23), **f32)
    rhs[:, :Lc] = subm[ct.long()] * valid_c.to(torch.float32)
    one, zero = torch.ones((), **f32), torch.zeros((), **f32)
    colsv = torch.arange(L2p + 1, device=dev)[None, :]
    pc = torch.where((colsv >= 1) & (colsv <= lb[:, None]), one,
                     zero)[:, None, :] * penv[None, :, None]
    rowsv = torch.arange(L1p + 1, device=dev)[None, :]
    pr = torch.where((rowsv >= 1) & (rowsv <= la[:, None]), one,
                     zero)[:, None, :] * penv[None, :, None]
    return lhs, rhs, pc.contiguous(), pr.contiguous()


def maps_from_steps(steps, swapped, Lmax: int):
    """Residue -> anchor position maps of a chunk of step lists
    (kalign_tpu/tpu/engine.py::_maps_from_steps_batch :999-1015): steps
    [B, S] int8 padded with traceback.STEP_PAD, swapped [B] bool.
    Returns maps [B, Lmax] int64, -1 where a residue is unmapped."""
    B, S = steps.shape
    valid = steps != tb.STEP_PAD
    gap_i = np.where(swapped, 2, 1).astype(np.int8)[:, None]
    gap_k = np.where(swapped, 1, 2).astype(np.int8)[:, None]
    pos_i = np.cumsum(steps != gap_i, axis=1) - 1
    pos_k = np.cumsum(steps != gap_k, axis=1) - 1
    sel = (steps == 0) & valid
    maps = np.full((B, Lmax), -1, dtype=np.int64)
    maps[np.nonzero(sel)[0], pos_i[sel]] = pos_k[sel]
    return maps


class GpuEngine:
    # cap on the [B, L1p, L2p] match bytes of one launch; bigger buckets
    # split into chunked launches
    MAX_MATCH_BYTES = 1 << 30
    # past the register row kernel's widths a launch holds only real
    # problems, as many as keep their bytes (problem_bytes: decisions,
    # match or its row blocks, state) within WIDE_LAUNCH_BYTES on each
    # card, at most WIDE_MAX_PROBLEMS a card (the 8 of the reference's
    # least launch, which the long genomes' 9,728-column launches fill),
    # down to one
    WIDE_LAUNCH_BYTES = 16 << 30
    WIDE_MAX_PROBLEMS = 8
    # centering-bias strength of the progressive merges (tpu/engine.py:686)
    EPS = 1e-3
    # centering-bias strength of the consistency-map DPs
    # (tpu/engine.py:987-996)
    MAP_EPS = 0.0
    # the device tree from this many sequences up (tpu/engine.py:317-319)
    DEVICE_TREE_MIN_SEQS = 2048
    # the fused tree up to this many sequences (KALIGN_TPU_FUSED_TREE_MAX)
    FUSED_TREE_MAX = 32768

    def __init__(self, device=None, resident: bool = True, device_tree=None,
                 fused_tree_max: int = FUSED_TREE_MAX, mesh=None):
        # a mesh (parallel/mesh.py) of more than one shard shards the
        # anchor distances and the merge buckets (tpu/engine.py:215-229):
        # the progressive pass is the host-assembled one, the lanewise and
        # fused routes are off, and the tree and the consistency maps run
        # on this process's first shard's device, the engine's device (on
        # a mesh across processes every process runs them, as kalign_tpu
        # runs them on each process's default device,
        # tpu/engine.py:1046-1051)
        if mesh is not None:
            if not mesh.local:
                raise ValueError(f"process {mesh.rank} owns no shard of the "
                                 "mesh")
            first = mesh.shards[mesh.local[0]].device
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"local shard ({first})")
            device = first
        self.device = torch.device(device)
        self.mesh = mesh
        self.sharded = mesh is not None and mesh.size > 1
        # the progressive pass: device-resident, or host-assembled
        self.resident = resident
        # the guide tree (KALIGN_TPU_DEVICE_TREE): None routes by device
        # and size, True / False force the device / native tree; the fused
        # device tree runs up to fused_tree_max sequences (0: never)
        self.device_tree = device_tree
        self.fused_tree_max = fused_tree_max
        # the match product is a full-fp32 bmm (the JAX engine leaves it
        # to XLA at f32): TF32 would round the scores to ~3 digits
        torch.backends.cuda.matmul.allow_tf32 = False
        # live alphabet width for the fused kernel (set_alphabet)
        self.nc = 0
        # per-run routing counts: problems (merges and map DPs, padding
        # included) per route, map DPs, bucket sizes per level, and each
        # launch batch's route, shape and lengths
        self.stats = {"engine": "gpu-fast" if mesh is None else "gpu-mesh",
                      "row_merges": 0, "lanewise_merges": 0,
                      "fused_merges": 0, "map_pairs": 0, "levels": [],
                      "batches": []}
        if mesh is not None:
            # the mesh's shards, cards and processes, the shards this
            # process runs, merges and map DPs through the column-sharded
            # DP (LongQueue), its walks' band crossings, the
            # decision bytes copied from one card to another (none: each
            # band's are walked on its card) and the gathers across
            # processes (the mesh's own count: calls, seconds)
            self.stats.update(shards=mesh.size, cards=mesh.cards,
                              processes=mesh.processes,
                              local_shards=list(mesh.local), long_merges=0,
                              long_maps=0, walk_handoffs=0,
                              dec_moved_bytes=0, gathers=mesh.gathers)
        # the column-sharded DPs queued ahead of their walks (long_queue)
        self._long = None
        # the progressive pass's host seconds by part (``split``), summed
        # over the passes, and its transfers to the host (``fetch``)
        self.stats["progressive_split_s"] = {}
        self.stats["fetches"] = 0
        # the guide tree that ran: native, device or device_fused
        self.stats["tree"] = None
        # per progressive pass, per multi-candidate merge: (chosen
        # candidate, the candidates' SP scores); "candidates" is the last
        self.stats["candidate_passes"] = []

    @staticmethod
    def split(part: str):
        """The block as the span ``progressive.<part>`` of the record under
        way (utils/logging.py; blocks do not nest): its host seconds go to
        msa.phase_times and, summed by progressive, to
        stats["progressive_split_s"]; under torch.profiler it is a range
        of that name, under which a trace lists the device time of the
        kernels it launched."""
        return span("progressive." + part)

    def long_queue(self):
        """The mesh's queue of column-sharded DPs (parallel/mesh.py::
        LongQueue), made at first use; it counts into stats."""
        if self._long is None:
            from kalign_tpu_torch.parallel import mesh as M
            self._long = M.LongQueue(self.mesh, self.stats)
        return self._long

    def map_sharded(self, L1p: int, L2p: int) -> bool:
        """A consistency-map DP of L1p x L2p takes the column-sharded
        route: on a mesh of more than one shard, where the card the
        one-card route runs it on (the engine's, launch_bucket) cannot
        hold the one problem (problem_bytes past its card_bytes; never
        off the card)."""
        if not self.sharded:
            return False
        have = card_bytes(self.device)
        return have is not None and problem_bytes(L1p, L2p) > have

    def fetch(self, x) -> np.ndarray:
        """One device-to-host transfer of the progressive pass, counted."""
        self.stats["fetches"] += 1
        return x.cpu().numpy()

    # ------------------------------------------------------------------
    def anchor_distances(self, codes, anchors):
        if self.sharded:
            from kalign_tpu_torch.parallel import mesh as M
            return M.anchor_distances(self.mesh, codes, anchors)
        return distances.anchor_distances(codes, anchors, self.device)

    def tree_route(self, n: int) -> str:
        """The guide tree for n sequences (tpu/engine.py:321-352): the
        device tree on the card from DEVICE_TREE_MIN_SEQS up (kalign_tpu
        takes it wherever it runs its Pallas kernels), the native one
        otherwise, either forced by ``device_tree``; the device tree
        tries the fused entry first up to ``fused_tree_max``.  Returns
        "native", "device_fused" or "device"."""
        use_device = self.device_tree
        if use_device is None:
            use_device = (self.device.type == "cuda"
                          and n >= self.DEVICE_TREE_MIN_SEQS)
        if not use_device:
            return "native"
        return "device_fused" if n <= self.fused_tree_max else "device"

    def build_tree(self, codes, dm, n_anchors):
        """The guide tree of tree_route.  Its parts are spans of the
        record under way ("tree.splits", "tree.upgma"; the native tree's
        "tree.pairs" too) and its pair counts go to stats
        (native.TREE_COUNTS); a device tree's host seconds by part also
        to stats["tree_s"] ("splits_s", "upgma_s").  The native tree takes
        its leaf sets' pair distances from one batch on the engine's
        device, each distinct pair once (stats["tree_pairs_batched"]); its
        tree is the one the native code makes alone."""
        route = self.tree_route(len(codes))
        if route == "native":
            self.stats["tree"] = route
            res = native.build_tree(
                codes, dm, n_anchors, counts=self.stats,
                pair_distances=lambda sets: distances.leaf_distances(
                    codes, sets, self.device))
            self.stats["tree_pairs_batched"] = \
                self.stats["tree_pairs_computed"]
            return res
        with recording() as rec:
            first = len(rec.spans)
            res = None
            if route == "device_fused":
                res = kmeans.build_tree_device_fused(
                    codes, dm, n_anchors, self.device, counts=self.stats)
                if res is None:
                    route = "device"      # the depth cap was hit
            if route == "device":
                res = kmeans.build_tree_device(codes, dm, n_anchors,
                                               self.device,
                                               counts=self.stats)
            self.stats["tree"] = route
            self.stats["tree_s"] = {
                part + "_s": secs
                for part, secs in rec.sums("tree.", first).items()}
        return res

    # realign's guide tree and identity distances stay on the host, as
    # kalign_tpu's TpuEngine delegates them (tpu/engine.py:354-358): no
    # kernel of the reference computes them
    def build_tree_pairwise(self, dm):
        return native.build_tree_pairwise(dm)

    def aln_pairwise_dist(self, rows):
        return native.aln_pairwise_dist(rows)

    # ------------------------------------------------------------------
    @staticmethod
    def live_nc(subm, max_code: int) -> int:
        """Live alphabet width for the fused kernel (tpu/engine.py:247-262
        at its default): 5 when the substitution matrix is zero outside
        the 5 x 5 nucleotide block and every token code is below 5 (then
        slicing the operands to 5 columns is exact), else 0 (no fused
        route)."""
        s = np.asarray(subm)
        if (max_code < 5 and s.shape[0] >= 5
                and not np.any(s[5:, :]) and not np.any(s[:, 5:])):
            return 5
        return 0

    def set_alphabet(self, codes, subm) -> None:
        max_code = max((int(np.max(c)) for c in codes if len(c)), default=0)
        self.nc = self.live_nc(subm, max_code)

    @staticmethod
    def lanewise_ok(Bp: int, L1p: int, L2p: int) -> bool:
        """The problem-per-lane kernel takes batches of k * 1024 problems
        that kalign_tpu's lanewise plan accepts (tpu/engine.py:264-273)."""
        return lanewise_feasible(Bp, L1p, L2p)

    @staticmethod
    def fused_ok(Bp: int, L1p: int, L2p: int, nc: int) -> bool:
        """The fused route's shape rule (tpu/engine.py:165-168)."""
        return nc > 0 and fused_feasible(Bp, L1p, L2p, nc)

    @staticmethod
    def row_feasible(B: int, L2p: int) -> bool:
        """The register row kernel holds the width (the counterpart of
        pick_plan's feasible, tpu/engine.py:409-411): no cluster
        instantiation or wave route."""
        return gotoh_row.launch_config(B, L2p).route == "row"

    def pad_to_launch(self, B: int) -> int:
        """Launch batch size (tpu/engine.py:287-296): a power of two (min
        8), on a mesh also at least and a multiple of the shard count."""
        Bp = _pow2_batch(B)
        if self.sharded:
            n = self.mesh.size
            Bp = -(-max(Bp, n) // n) * n
        return Bp

    def pads(self, L2p: int) -> bool:
        """Whether launches of width L2p are padded to a power of two with
        pad problems (tpu/engine.py:51-58, so the reference's routing of
        narrow buckets holds; on a mesh also to a multiple of the shard
        count): at the register row kernel's widths; past them (BAND_MAX,
        where row_feasible turns false) a launch holds only real
        problems, on a mesh too."""
        return L2p <= gotoh_row.BAND_MAX

    def max_launch(self, L1p: int, L2p: int, sharded: bool = False) -> int:
        """Problems of one launch: a power of two of at least 8 within
        MAX_MATCH_BYTES where launches pad (pads), else as many as keep
        their bytes within WIDE_LAUNCH_BYTES on a card, at most
        WIDE_MAX_PROBLEMS, at least one; ``sharded`` (a bucket over the
        mesh's batch axis): that many on each of the mesh's cards (a card
        per process and device, Mesh.cards), shared by the shards there
        (parallel/mesh.py::batch_counts)."""
        L1p, L2p = int(L1p), int(L2p)
        if not self.pads(L2p):
            per_card = max(1, min(self.WIDE_MAX_PROBLEMS,
                                  self.WIDE_LAUNCH_BYTES
                                  // problem_bytes(L1p, L2p)))
            return per_card * (self.mesh.cards if sharded else 1)
        cap = max(8, self.MAX_MATCH_BYTES // (L1p * L2p * 4))
        p = 8
        while p * 2 <= cap:
            p *= 2
        return p

    def put(self, x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t
        # pinned and asynchronous: a pageable copy would wait for the
        # stream, and the level's buckets could not queue behind one
        # another
        return t.pin_memory().to(self.device, non_blocking=True)

    def dispatch_bucket(self, lhs, rhs, pc, pr, la, lb, eps, bonus=None,
                        merges=None):
        """Queue one bucket of host arrays on the device (nothing is
        fetched): chunks of at most max_launch problems, each padded to a
        power of two where launches pad (pads), uploaded and launched
        (tpu/engine.py::_dispatch_bucket :361-465; a single-candidate
        bucket arrives padded already, a multi-candidate one as its K
        tiles).  A pad problem is 8 x 8 with the last problem's
        penalties, eps 0 and no bonus.  bonus is None or the compact tuple
        (per_w, apos_r, conf_r, apos_c, conf_c); merges counts the real
        problems (the first ones;
        default all).  On a mesh a bucket of at most as many merges as
        shards that the register row kernel cannot hold takes
        dispatch_long's route; the chunks of any other are sharded on
        their batch axis (padded as pad_to_launch pads where launches
        pad, else split unevenly, real problems only: each card holds at
        most max_launch's share).  Returns a handle for collect_bucket."""
        B = lhs.shape[0]
        merges = B if merges is None else merges
        if (self.sharded and merges <= self.mesh.size
                and not self.row_feasible(B, rhs.shape[1])):
            return self.dispatch_long(lhs, rhs, pc, pr, la, lb, eps, bonus,
                                      merges)
        return self.dispatch_chunks(lhs, rhs, pc, pr, la, lb, eps, bonus,
                                    merges)

    def dispatch_chunks(self, lhs, rhs, pc, pr, la, lb, eps, bonus,
                        merges: int):
        """dispatch_bucket's chunks of at most max_launch problems."""
        B = lhs.shape[0]
        pads = self.pads(rhs.shape[1])
        cap = self.max_launch(lhs.shape[1], rhs.shape[1], self.sharded)
        if B > cap:
            def part(x, lo):
                if x is None:
                    return None
                if isinstance(x, tuple):
                    return (x[0],) + tuple(a[lo:lo + cap] for a in x[1:])
                return x[lo:lo + cap]
            return ("multi", [
                self.dispatch_chunks(*(part(x, lo) for x in (
                    lhs, rhs, pc, pr, la, lb, eps, bonus)),
                    merges=min(cap, max(0, merges - lo)))
                for lo in range(0, B, cap)])
        lhs, rhs, pc, pr, la, lb, eps, bonus = pad_batch(
            lhs, rhs, pc, pr, la, lb, eps, bonus,
            self.pad_to_launch(B) - B if pads else 0)
        if self.sharded:
            # the batch axis over the mesh (tpu/engine.py:424-439)
            from kalign_tpu_torch.parallel import mesh as M
            self.stats["row_merges"] += len(la)
            self.stats["batches"].append(
                {"route": "row", "maps": False, "L1p": lhs.shape[1],
                 "L2p": rhs.shape[1], "la": np.array(la),
                 "lb": np.array(lb),
                 "shards": M.batch_counts(self.mesh, len(la))})
            return ("sharded", M.dispatch_bucket_step(
                self.mesh, lhs, rhs, pc, pr, la, lb, eps, bonus), B)
        bonus_d = None
        if bonus is not None:
            bonus_d = (torch.tensor(np.float32(bonus[0])).to(self.device),) \
                + tuple(self.put(a) for a in bonus[1:])
        handle = self.launch_bucket(
            *(self.put(x) for x in (lhs, rhs, pc, pr, la, lb, eps)),
            bonus_d, la, lb)
        return handle[:4] + (B,)

    def launch_bucket(self, lhs, rhs, pc, pr, la, lb, eps, bonus, la_h, lb_h,
                      maps=False):
        """Forward + walk of one launch batch of tensors on the engine's
        device (tpu/engine.py:441-491 with _fused_forward_lanewise
        :141-179): the fused kernel for bonus-free batches over a narrow
        alphabet that its rule accepts, else the match product (plus bias
        and bonus) and the lanewise or the row kernel.  la_h / lb_h are
        the host lengths, kept in stats."""
        B, L1p, _ = lhs.shape
        L2p = rhs.shape[1]
        max_steps = L1p + L2p + 2
        lanewise = not self.sharded and self.lanewise_ok(B, L1p, L2p)
        fused = (lanewise and bonus is None
                 and self.fused_ok(B, L1p, L2p, self.nc))
        route = "fused" if fused else "lanewise" if lanewise else "row"
        self.stats["batches"].append(
            {"route": route, "maps": maps, "L1p": L1p, "L2p": L2p,
             "la": np.array(la_h), "lb": np.array(lb_h)})
        self.stats[route + "_merges"] += B
        if route == "row":
            return ("walked", *row_route(lhs, rhs, pc, pr, la, lb, eps,
                                         bonus, la_h), B)
        if fused:
            nc = self.nc
            slope = lb.to(torch.float32) / torch.clamp(
                la.to(torch.float32), min=1.0)
            dec, score, st = gotoh_fused.forward(
                lhs[:, :, :nc].contiguous(), rhs[:, :, :nc].contiguous(),
                pc, pr, la, lb, slope, eps)
        else:
            match, slope, eps = bucket_match(lhs, rhs, la, lb, eps, bonus)
            dec, score, st = gotoh_lanewise.forward(match, pc, pr, la, lb,
                                                    slope, eps)
        steps, n = tb.walk_lanewise(dec, la, lb, st, max_steps)
        return ("walked", steps, n, score, B)

    def dispatch_long(self, lhs, rhs, pc, pr, la, lb, eps, bonus,
                      merges: int):
        """A launch batch of at most as many merges as shards, too wide for
        the register row kernel (row_feasible), on the mesh
        (tpu/engine.py:409-423): each merge with its columns in bands over
        the mesh (parallel/mesh.py::LongQueue.submit), queued on long_queue
        (walked there when later DPs need its room, else by
        collect_bucket).  kalign_tpu compares its padded batch with the
        device count; this counts the real merges.  On a mesh across
        processes it raises, naming the width, before anything is queued:
        the column-sharded DP runs within one process, as kalign_tpu's
        fails to fetch its decisions across processes (parallel/mesh.py:
        487)."""
        from kalign_tpu_torch.parallel import mesh as M
        if self.mesh.spans_processes:
            raise ValueError(
                f"a bucket of {merges} merges of {lhs.shape[1]} x "
                f"{rhs.shape[1]} (lb up to {int(np.max(lb[:merges]))}) "
                "takes the column-sharded route, which runs on a mesh "
                f"within one process; this mesh spans "
                f"{self.mesh.processes} processes")
        handles = []
        for k in range(merges):
            bk = None if bonus is None else \
                (bonus[0],) + tuple(a[k] for a in bonus[1:])
            handles.append(self.long_queue().submit(
                lhs[k], rhs[k], pc[k], pr[k], int(la[k]), int(lb[k]),
                float(eps[k]), bk))
        self.stats["long_merges"] += merges
        self.stats["batches"].append(
            {"route": "long", "maps": False, "L1p": lhs.shape[1],
             "L2p": rhs.shape[1], "la": np.array(la[:merges]),
             "lb": np.array(lb[:merges])})
        return ("long", handles, merges)

    def collect_bucket(self, handle):
        """Fetch one bucket's step lists: ([steps per merge], scores)."""
        if handle[0] == "multi":
            steps, scores = [], []
            for h in handle[1]:
                s, sc = self.collect_bucket(h)
                steps.extend(s)
                scores.append(sc)
            return steps, np.concatenate(scores)
        if handle[0] == "sharded":
            from kalign_tpu_torch.parallel import mesh as M
            # one fetch on each of this process's shards that got problems
            self.stats["fetches"] += len(handle[1])
            steps, scores = M.collect_bucket_step(self.mesh, handle[1])
            B = handle[2]
            return steps[:B], scores[:B]
        if handle[0] == "long":
            steps, scores = [], []
            for dp in handle[1]:
                st, sc = self.long_queue().walk(dp)
                self.stats["fetches"] += dp.fetches
                steps.append(st)
                scores.append(sc)
            return steps, np.asarray(scores, np.float64)
        _, steps, n, score, B = handle
        steps = self.fetch(steps[:B])
        n = self.fetch(n[:B])
        score = self.fetch(score[:B])
        return ([steps[b, :n[b]] for b in range(B)],
                score.astype(np.float64))

    # ------------------------------------------------------------------
    def dp_leaf_batch(self, codes, pairs, ap: P.AlnParam, maps_spec):
        """Batched leaf-against-leaf DPs over (rows_seq, cols_seq) index
        pairs (the consistency map workload; tpu/engine.py
        _dp_leaf_batch_device :1098-1187).  The token table goes to the
        device once; per launch only index vectors travel and the
        operands are assembled there (leaf_operands).  Buckets by padded
        shape, in sorted order, chunked by max_launch; where launches pad
        (pads) each chunk pads to a power of two with 8 x 8 problems on
        sequence 0.  Every chunk is launched before any is fetched; each
        chunk's step lists come back in one fetch and go straight into the
        map extraction.

        maps_spec[p] = (length of the mapped sequence, swapped) for pair
        p.  Returns the residue -> anchor position map of every pair."""
        lens = np.array([len(c) for c in codes], np.int32)
        pad = np.zeros((len(codes), int(lens.max())), np.uint8)
        for i, c in enumerate(codes):
            pad[i, :len(c)] = c
        tok = self.put(pad)
        subm = self.put(np.asarray(ap.subm, np.float32))
        penv = self.put(np.array([-ap.gpo, -ap.gpe, -ap.tgpe], np.float32))
        buckets = {}
        for idx, (ri, ci) in enumerate(pairs):
            key = (_bucket(lens[ri]), _bucket(lens[ci]))
            buckets.setdefault(key, []).append((idx, ri, ci))
        self.stats["map_pairs"] += len(pairs)

        dispatched = []
        long_items = []
        for (L1p, L2p), items in sorted(buckets.items()):
            if self.map_sharded(L1p, L2p):
                long_items.extend((L1p, L2p, it) for it in items)
                continue
            cap = self.max_launch(L1p, L2p)
            for lo in range(0, len(items), cap):
                chunk = items[lo:lo + cap]
                Bp = _pow2_batch(len(chunk)) if self.pads(L2p) else \
                    len(chunk)
                rows = np.zeros(Bp, np.int32)
                cols = np.zeros(Bp, np.int32)
                rows[:len(chunk)] = [ri for _, ri, _ in chunk]
                cols[:len(chunk)] = [ci for _, _, ci in chunk]
                la = np.full(Bp, 8, np.int32)
                lb = np.full(Bp, 8, np.int32)
                la[:len(chunk)] = lens[rows[:len(chunk)]]
                lb[:len(chunk)] = lens[cols[:len(chunk)]]
                la_d, lb_d = self.put(la), self.put(lb)
                lhs, rhs, pc, pr = leaf_operands(
                    tok, subm, penv, self.put(rows), self.put(cols), la_d,
                    lb_d, L1p, L2p)
                eps = torch.full((Bp,), self.MAP_EPS, dtype=torch.float32,
                                 device=self.device)
                handle = self.launch_bucket(lhs, rhs, pc, pr, la_d, lb_d,
                                            eps, None, la, lb, maps=True)
                dispatched.append((chunk, handle[1]))

        if long_items:
            dispatched.extend(self.long_maps(tok, subm, penv, lens,
                                             long_items))
        out: List[Optional[np.ndarray]] = [None] * len(pairs)
        for chunk, steps in dispatched:
            if callable(steps):         # a LongQueue's walk
                steps = steps()[0][None]
            else:
                steps = steps[:len(chunk)].cpu().numpy()
            li = np.array([maps_spec[idx][0] for idx, _, _ in chunk],
                          np.int64)
            sw = np.array([maps_spec[idx][1] for idx, _, _ in chunk], bool)
            maps = maps_from_steps(steps, sw, int(li.max()))
            for k, (idx, _, _) in enumerate(chunk):
                out[idx] = maps[k, :li[k]]
        return out

    def long_maps(self, tok, subm, penv, lens, items):
        """Map DPs that no card holds, each with its columns in bands over
        the mesh (long_queue: queued as far as the cards hold their bands,
        walked on the bands' cards), bonus-free at MAP_EPS as the one-card
        route runs them; operands made on the engine's card as the
        one-card route makes them (leaf_operands over dp_leaf_batch's
        token table tok, subm and penv; the span mesh.bands).  items:
        (L1p, L2p, (pair index, rows sequence, columns sequence)).
        Returns [([pair], walk)], walk() giving the pair's (steps, score).
        On a mesh across processes it raises, naming the width, before
        anything is queued, as dispatch_long does."""
        if self.mesh.spans_processes:
            raise ValueError(
                f"{len(items)} map DPs of up to {max(i[1] for i in items)} "
                "columns take the column-sharded route, which runs on a mesh "
                f"within one process; this mesh spans "
                f"{self.mesh.processes} processes")
        q = self.long_queue()
        out = []
        for L1p, L2p, (idx, ri, ci) in items:
            la, lb = int(lens[ri]), int(lens[ci])
            with span("mesh.bands"):
                one = self.put(np.array([[ri], [ci], [la], [lb]],
                                        np.int32))
                lhs, rhs, pc, pr = (x[0] for x in leaf_operands(
                    tok, subm, penv, *one, L1p, L2p))
            dp = q.submit(lhs, rhs, pc, pr, la, lb, self.MAP_EPS,
                          what="map DP")
            out.append(([(idx, ri, ci)], lambda dp=dp: q.walk(dp)))
            self.stats["long_maps"] += 1
            self.stats["batches"].append(
                {"route": "long", "maps": True, "L1p": L1p, "L2p": L2p,
                 "la": np.array([la]), "lb": np.array([lb])})
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def schedule(tasks, n: int):
        """The tasks sorted by parent id, parent -> task index, and the
        parents of each guide-tree level (a level's merges depend only on
        earlier levels)."""
        order = np.asarray(tasks)[np.argsort(np.asarray(tasks)[:, 2])]
        task_index = {int(c): t for t, (_, _, c) in enumerate(order)}
        level = {i: 0 for i in range(n)}
        levels: List[List[int]] = []
        for a, b, c in order:
            lv = 1 + max(level[int(a)], level[int(b)])
            level[int(c)] = lv
            while len(levels) < lv:
                levels.append([])
            levels[lv - 1].append(int(c))
        return order, task_index, levels

    # centering-bias candidates of refinement (tpu/engine.py:663-698):
    # every merge's full set, and the confident mode's probe
    REFINE_FULL = (1e-3, 0.0, 4e-3)
    REFINE_PROBE = (1e-3, 0.0)

    def align(self, codes, tasks, ap: P.AlnParam, seq_distances, ct=None,
              refine_mode: int = P.REFINE_NONE):
        """The progressive alignment (tpu/engine.py::TpuEngine.align
        :633-698), with the consistency bonus of table ct when given; the
        fused route takes the alphabet width of the last set_alphabet.
        Refinement runs K candidate DPs per merge, one per centering-bias
        strength, and keeps the path of the best expected sum-of-pairs:
        every merge with REFINE_FULL (refine all or inline), or
        (confident) a probe pass with REFINE_PROBE, then a replay with
        REFINE_FULL on the merges whose probe paths disagreed and EPS
        alone elsewhere (stats["refine_flagged"] counts them).  Returns
        (gaps per sequence, per-merge scores indexed like the tasks sorted
        by parent id: the DP score, or the chosen path's SP where K > 1).
        On a mesh across processes every process must hold the same tasks
        and maps before the first bucket (one gather of a digest)."""
        if self.mesh is not None:
            from kalign_tpu_torch.parallel import mesh as M
            maps = () if ct is None else (np.asarray(ct.anchor_ids),
                                          *ct.pos_maps)
            M.same_on_every_process(self.mesh, "guide trees or consistency "
                                    "maps", np.asarray(tasks, np.int64),
                                    *maps)
        sd = None if seq_distances is None else np.asarray(seq_distances)
        sched = self.schedule(tasks, len(codes))
        if refine_mode == P.REFINE_CONFIDENT:
            probe, full = self.REFINE_PROBE, self.REFINE_FULL
            _, _, disagree = self.progressive(codes, sched, ap, sd, ct,
                                              lambda t: probe)
            self.stats["refine_flagged"] = int(disagree.sum())
            gaps, conf, _ = self.progressive(
                codes, sched, ap, sd, ct,
                lambda t: full if disagree[t] else (self.EPS,))
            return gaps, conf
        cand = ((self.EPS,) if refine_mode == P.REFINE_NONE
                else self.REFINE_FULL)
        gaps, conf, _ = self.progressive(codes, sched, ap, sd, ct,
                                         lambda t: cand)
        return gaps, conf

    def progressive(self, codes, sched, ap: P.AlnParam, sd, ct, cand_for):
        """One bottom-up pass: device-resident, or host-assembled
        (``resident=False``).  cand_for(task index) is the merge's tuple of
        centering-bias candidates.  Returns (gaps, conf, disagree [n - 1]
        bool: the merges whose candidates gave more than one path).  The
        seconds of the pass's ``split`` spans add to
        stats["progressive_split_s"]."""
        order, task_index, levels = sched
        self.stats["candidates"] = {}
        self.stats["candidate_passes"].append(self.stats["candidates"])
        with recording() as rec:
            first = len(rec.spans)
            try:
                if self.resident and not self.sharded:
                    # imported here: gpu/resident.py imports this module
                    from kalign_tpu_torch.gpu.resident import ResidentPass
                    return ResidentPass(self, codes, ap, sd, ct,
                                        cand_for).run(order, task_index,
                                                      levels)
                return self.host_pass(codes, order, task_index, levels, ap,
                                      sd, ct, cand_for)
            finally:
                split = self.stats["progressive_split_s"]
                for part, secs in rec.sums("progressive.", first).items():
                    split[part] = split.get(part, 0.0) + secs

    def host_pass(self, codes, order, task_index, levels, ap: P.AlnParam,
                  sd, ct, cand_for):
        """The host-assembled progressive pass (tpu/engine.py::
        _progressive :731-901): each bucket assembled in numpy, uploaded
        and launched, every bucket's step lists fetched, then merged and
        woven in numpy.  Buckets are keyed by padded shape and candidate
        tuple; a bucket of K > 1 candidates runs its problems K times over
        (tiled, eps repeated) and keeps each merge's best path by SP
        (select_candidates)."""
        split = self.split
        n = len(codes)
        nprof = 2 * n - 1
        lens = [len(c) for c in codes]
        gaps = [[0] * (l + 1) for l in lens]
        sip: List[Optional[List[int]]] = [[i] for i in range(n)] + \
            [None] * (n - 1)
        nsip = [1] * n + [0] * (n - 1)
        profiles: List[Optional[Profile]] = [None] * nprof
        conf = np.zeros(n - 1, dtype=np.float32)
        disagree = np.zeros(n - 1, dtype=bool)

        for lv_nodes in levels:
            with split("assembly"):
                batch = []
                for c in lv_nodes:
                    t_idx = task_index[c]
                    a, b = int(order[t_idx][0]), int(order[t_idx][1])
                    eff = self.effective(ap, sd, sip, a, b, n)
                    pa = self.node_profile(profiles, codes, a, nsip, eff)
                    pb = self.node_profile(profiles, codes, b, nsip, eff)
                    leaf_a = nsip[a] == 1
                    leaf_b = nsip[b] == 1
                    if leaf_a and not leaf_b:
                        rows_node = b
                    elif leaf_b and not leaf_a:
                        rows_node = a
                    elif pa.length <= pb.length:
                        rows_node = a
                    else:
                        rows_node = b
                    cols_node = b if rows_node == a else a
                    prof_r = pa if rows_node == a else pb
                    prof_c = pb if rows_node == a else pa
                    cols_is_leaf = (nsip[cols_node] == 1
                                    and not (leaf_a and leaf_b))
                    batch.append((c, a, b, rows_node, cols_node, prof_r,
                                  prof_c, cols_is_leaf))

                buckets = {}
                for item in batch:
                    key = (_bucket(item[5].length), _bucket(item[6].length),
                           tuple(cand_for(task_index[item[0]])))
                    buckets.setdefault(key, []).append(item)
                self.stats["levels"].append(level_buckets(buckets))

            # dispatch every bucket of the level, then collect
            dispatched = []
            for (L1p, L2p, cands), items in buckets.items():
                K = len(cands)
                with split("assembly"):
                    B = len(items)
                    # a multi-candidate bucket is tiled K times, then
                    # padded by dispatch_bucket (where launches pad)
                    Ba = self.pad_to_launch(B) if K == 1 and \
                        self.pads(L2p) else B
                    pc = np.zeros((Ba, 3, L2p + 1), np.float32)
                    pr = np.zeros((Ba, 3, L1p + 1), np.float32)
                    la = np.full(Ba, 8, np.int32)
                    lb = np.full(Ba, 8, np.int32)
                    lhs = np.zeros((Ba, L1p, 23), np.float32)
                    rhs = np.zeros((Ba, L2p, 23), np.float32)
                    for k, (c, a, b, rn, cn, prof_r, prof_c, cif) in \
                            enumerate(items):
                        la[k] = prof_r.length
                        lb[k] = prof_c.length
                        if cif:
                            lhs[k, :la[k]] = prof_r.subrows
                            rhs[k, :lb[k]] = prof_c.counts
                        else:
                            lhs[k, :la[k]] = prof_r.counts
                            rhs[k, :lb[k]] = prof_c.subrows
                        pc[k, :, 1:lb[k] + 1] = (prof_c.pen[1:-1] *
                                                 np.float32(nsip[rn])).T
                        pr[k, :, 1:la[k] + 1] = (prof_r.pen[1:-1] *
                                                 np.float32(nsip[cn])).T
                    # pad problems are 8 x 8 with copies of the last real
                    # problem's penalties
                    if Ba > B:
                        pc[B:] = pc[B - 1]
                        pr[B:] = pr[B - 1]
                    eps = np.full(Ba, cands[0], np.float32)
                bonus = None
                if ct is not None:
                    with split("bonus"):
                        # compact per-anchor positions and confidences;
                        # the bonus matrix is built on the device
                        bonus = (ct.per_weight,
                                 np.full((Ba, ct.K, L1p), -1, np.int32),
                                 np.zeros((Ba, ct.K, L1p), np.float32),
                                 np.full((Ba, ct.K, L2p), -1, np.int32),
                                 np.zeros((Ba, ct.K, L2p), np.float32))
                        for k, (c, a, b, rn, cn, prof_r, prof_c, _) in \
                                enumerate(items):
                            apr, cfr, apc, cfc = ct.bonus_arrays(
                                rn, prof_r.length, cn, prof_c.length, sip,
                                nsip, gaps, lens)
                            bonus[1][k, :, :la[k]] = apr
                            bonus[2][k, :, :la[k]] = cfr
                            bonus[3][k, :, :lb[k]] = apc
                            bonus[4][k, :, :lb[k]] = cfc
                if K > 1:
                    lhs, rhs, pc, pr = (np.concatenate([x] * K)
                                        for x in (lhs, rhs, pc, pr))
                    la, lb = np.tile(la, K), np.tile(lb, K)
                    if bonus is not None:
                        bonus = (bonus[0],) + tuple(
                            np.concatenate([x] * K) for x in bonus[1:])
                    eps = np.repeat(np.asarray(cands, np.float32), B)
                with split("dispatch"):
                    dispatched.append((items, K, self.dispatch_bucket(
                        lhs, rhs, pc, pr, la, lb, eps, bonus,
                        merges=B * K)))

            for items, K, handle in dispatched:
                with split("fetch"):
                    steps_list, scores = self.collect_bucket(handle)
                if K > 1:
                    with split("refine"):
                        steps_list, scores, multi = self.select_candidates(
                            items, steps_list, K, sip, nsip, gaps, lens, ap,
                            task_index)
                    for k, it in enumerate(items):
                        disagree[task_index[it[0]]] = multi[k]
                for k, (c, a, b, rn, cn, prof_r, prof_c, _) in \
                        enumerate(items):
                    with split("merge"):
                        steps_rc = np.asarray(steps_list[k], np.int8)
                        if rn == a:
                            steps = steps_rc
                        else:
                            steps = np.where(steps_rc == 1, 2,
                                             np.where(steps_rc == 2, 1,
                                                      0)).astype(np.int8)
                        conf[task_index[c]] = scores[k]
                        terminal = terminal_mask(steps)
                        prof_a = prof_r if rn == a else prof_c
                        prof_b = prof_c if rn == a else prof_r
                        profiles[c] = merge_profiles(
                            prof_a, prof_b, steps, terminal, nsip[a],
                            nsip[b], ap.gpo, ap.gpe, ap.tgpe)
                        profiles[a] = None
                        profiles[b] = None
                    with split("weave"):
                        weave_steps(steps, gaps, sip[a], sip[b])
                    nsip[c] = nsip[a] + nsip[b]
                    sip[c] = list(reversed(sip[a])) + list(reversed(sip[b]))
        return gaps, conf, disagree

    def select_candidates(self, items, all_steps, K: int, sip, nsip, gaps,
                          lens, ap: P.AlnParam, task_index):
        """Each merge's best candidate by expected SP in float64
        (tpu/engine.py::_select_candidates :929-960, the reference's trial
        selection aln_refine.c:198-253): identical paths scored once,
        the first strictly better kept.  all_steps holds candidate v of
        merge k at v * B + k.  Returns (steps, SP scores, disagree)."""
        B = len(items)
        steps_out = []
        scores_out = np.zeros(B, dtype=np.float64)
        multi_out = np.zeros(B, dtype=bool)
        for k, (c, a, b, rn, cn, prof_r, prof_c, _) in enumerate(items):
            ga = column_gap_counts(prof_r.length, nsip[rn], sip[rn], lens,
                                   gaps)
            gb = column_gap_counts(prof_c.length, nsip[cn], sip[cn], lens,
                                   gaps)
            best, best_sp, best_v = None, -np.inf, 0
            seen = {}
            sps = []
            for v in range(K):
                st = np.asarray(all_steps[v * B + k], np.int8)
                key = st.tobytes()
                if key not in seen:
                    seen[key] = sp_score_from_profiles(
                        prof_r, prof_c, st, terminal_mask(st), nsip[rn],
                        nsip[cn], ga, gb, ap.subm, ap.gpo, ap.gpe, ap.tgpe)
                    if seen[key] > best_sp:
                        best, best_sp, best_v = st, seen[key], v
                sps.append(seen[key])
            steps_out.append(best)
            scores_out[k] = best_sp
            multi_out[k] = len(seen) > 1
            self.stats["candidates"][task_index[c]] = (best_v, sps)
        return steps_out, scores_out, multi_out

    # ------------------------------------------------------------------
    @staticmethod
    def effective(ap: P.AlnParam, sd, sip, a, b, n):
        """Distance-scaled penalties and the VSM substitution offset of
        one merge (tpu/engine.py:962-978)."""
        gs, so = 1.0, 0.0
        if sd is not None:
            members = [s for s in sip[a] if s < n] + \
                [s for s in sip[b] if s < n]
            if members:
                avg = float(np.mean(sd[members], dtype=np.float64))
                if ap.dist_scale > 0.0:
                    gs = min(1.0, max(0.3, 1.0 - ap.dist_scale * avg))
                if ap.vsm_amax > 0.0:
                    so = max(0.0, ap.vsm_amax - avg)
        eff = P.AlnParam(**{**ap.__dict__})
        if gs < 1.0 or so > 0.0:
            eff.gpo = ap.gpo * gs
            eff.gpe = ap.gpe * gs
            eff.tgpe = ap.tgpe * gs
            eff.subm_offset = so
        return eff

    @staticmethod
    def node_profile(profiles, codes, node, nsip, eff: P.AlnParam):
        if profiles[node] is None:
            assert nsip[node] == 1
            profiles[node] = leaf_profile(codes[node], eff.subm, eff.gpo,
                                          eff.gpe, eff.tgpe, eff.subm_offset)
        return profiles[node]
