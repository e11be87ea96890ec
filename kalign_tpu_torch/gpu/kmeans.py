"""Device bisecting k-means guide tree (the tree route at scale).

Counterpart of kalign_tpu/tpu/kmeans.py.  The reference's guide tree
(bisectingKmeans.c:318-363) splits each cluster of 50 or more sequences
in two by the best of 40 seeded 2-means tries, each a Lloyd loop over
the N x D anchor-distance embedding, and joins clusters below 50 by
native UPGMA over pairwise BPM distances.  ``build_tree_device`` runs
the splits one recursion depth at a time, ``build_tree_device_fused``
keeps cluster membership on the device as binary path codes (root 1,
child 2 * code + side) and fetches only the final codes;
``GpuEngine.build_tree`` routes between them and the native tree.

Kernel: csrc/kmeans.cu (replaces the XLA programs _lloyd_batch :46 and
the Lloyd loop of _fused_splits :322, neither a Pallas kernel): one
thread-block cluster per (cluster, try) runs its Lloyd loop to the end on
the card, its blocks (``cluster_blocks``) sharing the members and adding
their partial sums through distributed shared memory; ``lloyd`` launches
it for CUDA tensors.  The plain versions
``lloyd_batch`` and ``fused_splits`` follow the reference formula for
formula (``||x||^2 - 2 x.c + ||c||^2`` distances on the sqrt scale,
the |dr - dl| < 1e-6 tie broken by parity, the per-dimension move test,
one unconditional first pass then ``it + 1 < 500``, inactive tries
scored 3.4e38, the earliest best try); the CPU runs them, and on the
card the tests and ``chip_smoke.py`` hold the kernel against them.

Contract (kmeans.py:18-26): the tree is fixed for a fixed device and
program but is not the native tree, and the kernel's float order is not
the plain versions': a member within float noise of the tie boundary
may go the other way, and then the splits below it differ.  Such splits
tie: their best tries' SSE agree to float noise (``compare_traces``).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from kalign_tpu_torch import native
from kalign_tpu_torch.gpu import _cuda
from kalign_tpu_torch.utils.logging import span

UPGMA_THRESHOLD = 50   # KALIGN_KMEANS_UPGMA_THRESHOLD (CMakeLists.txt:71)
MAX_ITERS = 500
EPS = 1e-6
MAX_TRIES = 40
_PAD_CID = 1 << 28     # sorts after every real path code
# members per block of the kernel's thread-block clusters, and the most
# blocks a cluster takes (csrc/kmeans.cu kMaxBlocks)
ROWS_PER_BLOCK = 1024
MAX_CLUSTER_BLOCKS = 16
_FUSED_DEPTH_CAP = 24  # path codes stay < 2^25 (int32-safe)
MAX_D = 32             # anchors the kernel takes (csrc/kmeans.cu kMaxD)
# the score of an inactive try
NO_SCORE = float(np.float32(3.4e38))
# the per-depth entry's cluster-size buckets and slots per launch (the
# plain version's launch shapes, kalign_tpu/tpu/kmeans.py:161-172)
S_BUCKETS = (256, 2048, 16384, 131072)

launches = 0


def _pow2_at_least(n: int) -> int:
    p = 64
    while p < n:
        p *= 2
    return p


def _ctile(S: int) -> int:
    return max(1, (1 << 18) // S)


# ---------------------------------------------------------------------------
# the kernel
def cluster_blocks(n: int) -> int:
    """Blocks of the kernel's thread-block cluster for a launch whose
    largest cluster has n members: a power of two, ROWS_PER_BLOCK members
    a block, at most MAX_CLUSTER_BLOCKS (a non-portable size that the
    H100 takes; a card that refuses it refuses the launch, which raises)."""
    want = max(1, -(-int(n) // ROWS_PER_BLOCK))
    b = 1
    while b < want and b < MAX_CLUSTER_BLOCKS:
        b *= 2
    return b


def lloyd(rows, start, size, form: int, T: int = MAX_TRIES,
          max_iters: int = MAX_ITERS, max_size=None):
    """Launch csrc/kmeans.cu: every try of every cluster, a cluster being
    the rows [start[c], start[c] + size[c]) of rows [N, D] (CUDA float32,
    D <= 32; start and size int32 on the same card).  form 0 reflects the
    seed as _lloyd_batch does, form 1 as _fused_splits does.  max_size
    is the largest size (fetched from the card when not given): it sets
    the blocks per cluster (cluster_blocks).  Returns
    (assign [T, N] int8, 1 = right, of the rows the clusters cover;
    score [C, T] float32 SSE, 3.4e38 for an inactive try; degen [C, T]
    int8; iters [C, T] int32)."""
    global launches
    if not (rows.is_cuda and start.is_cuda and size.is_cuda):
        raise ValueError("kmeans.lloyd: CUDA tensors are required")
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError("kmeans.lloyd: rows must be [N, D] float32")
    N, D = rows.shape
    if not 1 <= D <= MAX_D:
        raise ValueError(f"kmeans.lloyd: D = {D} anchors (1..{MAX_D})")
    rows = rows.contiguous()
    start = start.to(torch.int32).contiguous()
    size = size.to(torch.int32).contiguous()
    if not (rows.device == start.device == size.device):
        raise ValueError("kmeans.lloyd: all inputs must be on one CUDA "
                         "device")
    C = start.shape[0]
    dev = rows.device
    score = torch.empty((C, T), dtype=torch.float32, device=dev)
    degen = torch.empty((C, T), dtype=torch.int8, device=dev)
    assign = torch.zeros((T, N), dtype=torch.int8, device=dev)
    iters = torch.empty((C, T), dtype=torch.int32, device=dev)
    if C:
        if max_size is None:
            max_size = int(size.max())
        blocks = cluster_blocks(max_size)
        with torch.cuda.device(dev):
            _cuda.require_cuda("kmeans.lloyd", rows, start, size)
            rc = _cuda.lib().kt_kmeans_lloyd(
                rows.data_ptr(), D, N, start.data_ptr(), size.data_ptr(), C,
                T, form, max_iters, EPS, score.data_ptr(), degen.data_ptr(),
                assign.data_ptr(), iters.data_ptr(), blocks,
                _cuda.stream(dev))
        _cuda.check(rc, "kmeans.lloyd")
        launches += 1
    return assign, score, degen, iters


def best_tries(assign, score, degen, slot_of_row):
    """The earliest best try of each cluster (argmin over its tries, the
    first of equal SSE) and, per row, that try's assignment: (right [N]
    bool, degenerate [C] bool, best SSE [C]).  slot_of_row [N] int64 is
    each row's cluster (rows of no cluster: any valid index)."""
    t_best = torch.argmin(score, dim=1)
    rows = torch.arange(assign.shape[1], device=assign.device)
    right = assign[t_best[slot_of_row], rows] == 1
    c = torch.arange(score.shape[0], device=score.device)
    return right, degen[c, t_best] == 1, score[c, t_best]


# ---------------------------------------------------------------------------
# plain versions
def lloyd_batch(emb, idx, valid, parity, seeds, n_tries, T: int):
    """kalign_tpu/tpu/kmeans.py::_lloyd_batch :46 in PyTorch: all tries of
    a group of clusters in lockstep.  emb [N, D] f32; idx, valid, parity
    [C, S] (sample ids, mask, position & 1); seeds [C, T] seed slots;
    n_tries [C].  Returns the earliest best try's (assign [C, S] int8,
    degenerate [C] bool, SSE [C] f32)."""
    f32 = torch.float32
    dev = emb.device
    zero = torch.zeros((), dtype=f32, device=dev)
    safe = idx.clamp(0, emb.shape[0] - 1).long()
    rows = torch.where(valid[:, :, None], emb[safe], zero)
    C, S, D = rows.shape
    nsf = valid.sum(dim=1).to(f32)[:, None]
    mean = rows.sum(dim=1) / torch.clamp(nsf, min=1.0)
    cl0 = torch.gather(rows, 1, seeds.long()[:, :, None].expand(C, T, D))
    cr0 = mean[:, None, :] - (cl0 - mean[:, None, :])
    sq_rows = (rows * rows).sum(dim=2)
    try_active0 = torch.arange(T, device=dev)[None, :] < n_tries[:, None]
    validf = valid[:, None, :]
    odd = (parity == 1)[:, None, :]

    def dists(c):
        xc = torch.einsum("csd,ctd->cts", rows, c)
        d2 = sq_rows[:, None, :] - 2.0 * xc + (c * c).sum(dim=2)[:, :, None]
        return torch.sqrt(torch.clamp(d2, min=0.0))

    def body(cl, cr, active, it):
        dl, dr = dists(cl), dists(cr)
        diff = dr - dl
        tie = torch.abs(diff) < EPS
        right = torch.where(tie, odd, diff < 0) & validf
        left = ~right & validf
        score = torch.where(validf, torch.minimum(dl, dr), zero).sum(dim=2)
        num_l = left.sum(dim=2).to(f32)
        num_r = right.sum(dim=2).to(f32)
        degenerate = (num_l == 0) | (num_r == 0)
        wl = torch.einsum("cts,csd->ctd", left.to(f32), rows) \
            / torch.clamp(num_l, min=1.0)[:, :, None]
        wr = torch.einsum("cts,csd->ctd", right.to(f32), rows) \
            / torch.clamp(num_r, min=1.0)[:, :, None]
        moved = ((torch.abs(wl - cl) >= EPS)
                 | (torch.abs(wr - cr) >= EPS)).any(dim=2)
        still = active & moved & ~degenerate & (it + 1 < MAX_ITERS)
        cl = torch.where(still[:, :, None], wl, cl)
        cr = torch.where(still[:, :, None], wr, cr)
        return cl, cr, right, score, degenerate, still

    # one unconditional first pass, then iterate while any try moves
    cl, cr, right, score, degenerate, still = body(cl0, cr0, try_active0, 0)
    it = 1
    while bool(still.any()):
        cl, cr, right, score, degenerate, still = body(cl, cr, still, it)
        it += 1
    score = torch.where(try_active0, score,
                        torch.full((), NO_SCORE, dtype=f32, device=dev))
    t_best = torch.argmin(score, dim=1)
    c = torch.arange(C, device=dev)
    return (right[c, t_best].to(torch.int8), degenerate[c, t_best],
            score[c, t_best])


def _segment_sum(x, seg, n: int):
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def segments(cid, done, iota, Np: int, Ca: int, T: int):
    """One depth's segments of the fused recursion
    (kalign_tpu/tpu/kmeans.py:352-381): rows sorted stably by path code;
    per sorted row its original index, rank in its cluster, the cluster's
    start and size, whether it is split this depth (act) and its active
    slot (Ca when inactive); per slot its start and size; the number of
    active slots; the done flags after this depth's size test."""
    cid_s, sidx = torch.sort(cid, stable=True)
    done_s = done[sidx]
    flag = torch.cat([torch.ones(1, dtype=torch.bool, device=cid.device),
                      cid_s[1:] != cid_s[:-1]])
    start = torch.cummax(torch.where(flag, iota, 0), dim=0).values
    rank = iota - start
    vals = torch.where(flag, iota, Np)
    shifted = torch.cat([vals[1:], torch.full((1,), Np, dtype=iota.dtype,
                                              device=cid.device)])
    nxt = torch.flip(torch.cummin(torch.flip(shifted, [0]), dim=0).values,
                     [0])
    size = nxt - start
    act = (size >= UPGMA_THRESHOLD) & ~done_s
    done_s_new = done_s | (size < UPGMA_THRESHOLD)
    is_astart = flag & act
    aslot_raw = torch.cumsum(is_astart.to(torch.int32), dim=0) - 1
    aslot = torch.where(act, aslot_raw, Ca).long()
    n_act = is_astart.sum()
    slot_ids = torch.where(is_astart, aslot_raw, Ca).long()
    zeros = torch.zeros(Ca + 1, dtype=iota.dtype, device=cid.device)
    st_a = zeros.clone()
    st_a[slot_ids] = torch.where(is_astart, start, 0)
    size_a = zeros.clone()
    size_a[slot_ids] = torch.where(is_astart, size, 0)
    return dict(cid_s=cid_s, sidx=sidx, rank=rank, size=size, act=act,
                aslot=aslot, n_act=n_act, st_a=st_a, size_a=size_a,
                done_s_new=done_s_new)


def plain_depth_split(rows, sg, Ca: int, T: int):
    """The Lloyd loop of one depth of _fused_splits (:383-450) in PyTorch
    over the sorted rows: (right_best [Np] bool, degenerate of the best
    try per row [Np] bool, best SSE per slot [Ca + 1])."""
    f32 = torch.float32
    dev = rows.device
    Np = rows.shape[0]
    zero = torch.zeros((), dtype=f32, device=dev)
    act, aslot, rank = sg["act"], sg["aslot"], sg["rank"]
    st_a, size_a, n_act = sg["st_a"], sg["size_a"], sg["n_act"]
    sq_rows = (rows * rows).sum(dim=1)
    step_a = torch.clamp(size_a // T, min=0)
    seed_pos = torch.clamp(st_a[:, None] + torch.arange(T, device=dev)[None, :]
                           * step_a[:, None], 0, Np - 1)
    cl0 = rows[seed_pos.reshape(-1)].reshape(Ca + 1, T, rows.shape[1])
    count_a = torch.clamp(size_a.to(f32), min=1.0)
    mean_a = _segment_sum(torch.where(act[:, None], rows, zero), aslot,
                          Ca + 1) / count_a[:, None]
    cr0 = 2.0 * mean_a[:, None, :] - cl0
    parity1 = (rank & 1) == 1
    slot = torch.clamp(aslot, 0, Ca)

    def dist_to(c):
        c_s = c[slot]
        xc = torch.einsum("nd,ntd->nt", rows, c_s)
        d2 = sq_rows[:, None] - 2.0 * xc + (c_s * c_s).sum(dim=2)
        return torch.sqrt(torch.clamp(d2, min=0.0))

    def lbody(cl, cr, still, it):
        dl, dr = dist_to(cl), dist_to(cr)
        diff = dr - dl
        tie = torch.abs(diff) < EPS
        right = torch.where(tie, parity1[:, None], diff < 0.0) & act[:, None]
        left = ~right & act[:, None]
        mind = torch.where(act[:, None], torch.minimum(dl, dr), zero)
        score = _segment_sum(mind, aslot, Ca + 1)
        num_r = _segment_sum(right.to(f32), aslot, Ca + 1)
        num_l = _segment_sum(left.to(f32), aslot, Ca + 1)
        degen = (num_l == 0.0) | (num_r == 0.0)
        wl = _segment_sum(rows[:, None, :] * left[:, :, None].to(f32), aslot,
                          Ca + 1) / torch.clamp(num_l, min=1.0)[:, :, None]
        wr = _segment_sum(rows[:, None, :] * right[:, :, None].to(f32), aslot,
                          Ca + 1) / torch.clamp(num_r, min=1.0)[:, :, None]
        moved = ((torch.abs(wl - cl) >= EPS)
                 | (torch.abs(wr - cr) >= EPS)).any(dim=2)
        still_new = still & moved & ~degen & (it + 1 < MAX_ITERS)
        cl = torch.where(still_new[:, :, None], wl, cl)
        cr = torch.where(still_new[:, :, None], wr, cr)
        return cl, cr, right, score, degen, still_new

    slot_active = (torch.arange(Ca + 1, device=dev)[:, None] < n_act)
    still0 = slot_active.expand(Ca + 1, T)
    cl, cr, right, score, degen, still = lbody(cl0, cr0, still0, 0)
    it = 1
    while bool(still.any()):
        cl, cr, right, score, degen, still = lbody(cl, cr, still, it)
        it += 1
    t_best = torch.argmin(score, dim=1)
    tb_s = t_best[slot]
    r_best = right.gather(1, tb_s[:, None])[:, 0]
    deg_best = degen[slot, tb_s]
    c = torch.arange(Ca + 1, device=dev)
    return r_best, deg_best, score[c, t_best]


def kernel_depth_split(rows, sg, Ca: int, T: int, n_act: int,
                       max_size: int):
    """One depth's splits through the kernel: the active slots are the
    segments [st_a, st_a + size_a) of the sorted rows (slots past n_act
    are empty; the largest has max_size rows).  Returns what
    plain_depth_split returns."""
    assign, score, degen, _ = lloyd(rows, sg["st_a"][:n_act],
                                    sg["size_a"][:n_act], form=1, T=T,
                                    max_size=max_size)
    slot = torch.clamp(sg["aslot"], 0, max(n_act - 1, 0))
    right, deg, sse = best_tries(assign, score, degen, slot)
    deg_row = deg[slot]
    pad = torch.zeros(Ca + 1 - n_act, dtype=sse.dtype, device=sse.device)
    return right & sg["act"], deg_row, torch.cat([sse, pad])


def fused_splits(emb, n: int, Np: int, T: int, Dmax: int, Ca: int,
                 kernel: bool = False, trace=None):
    """kalign_tpu/tpu/kmeans.py::_fused_splits :322: the whole bisecting
    recursion over emb [Np, D] (rows >= n zero), membership as path
    codes.  Each depth sorts the rows by code (stable: members keep
    ascending original index), splits every cluster of 50 or more not yet
    done by its earliest best try (the middle split, rank >= size // 2,
    when that try left a side empty), and marks clusters below 50 done.
    With kernel=False each depth's Lloyd loop is plain_depth_split (the
    reference's formulas); with kernel=True it is csrc/kmeans.cu, and
    the loop's condition is read from the card once per depth (one small
    fetch; the plain loop reads it each iteration).  Returns (cid [Np]
    int32, True when a cluster was still to split at depth Dmax)."""
    dev = emb.device
    iota = torch.arange(Np, dtype=torch.int64, device=dev)
    cid = torch.where(iota < n, 1, _PAD_CID).to(torch.int64)
    done = iota >= n
    depth = 0
    while True:
        sg = segments(cid, done, iota, Np, Ca, T)
        left, n_act, max_size = (int(x) for x in torch.stack(
            [(~done).any().long(), sg["n_act"].long(),
             sg["size_a"].max().long()]).cpu())
        if not left or depth >= Dmax:
            return cid.to(torch.int32), bool(left)
        rows = emb[sg["sidx"]]
        if n_act == 0:
            cid_s_new = sg["cid_s"]
        else:
            if kernel:
                r_best, deg_best, sse = kernel_depth_split(rows, sg, Ca, T,
                                                           n_act, max_size)
            else:
                r_best, deg_best, sse = plain_depth_split(rows, sg, Ca, T)
            side = torch.where(deg_best, sg["rank"] >= sg["size"] // 2,
                               r_best)
            cid_s_new = torch.where(sg["act"], 2 * sg["cid_s"] + side.long(),
                                    sg["cid_s"])
            if trace is not None:
                _trace_fused(trace, depth, sg, side, sse, n_act)
        cid = torch.zeros_like(cid)
        cid[sg["sidx"]] = cid_s_new
        done_new = torch.zeros_like(done)
        done_new[sg["sidx"]] = sg["done_s_new"]
        done = done_new
        depth += 1


# ---------------------------------------------------------------------------
# split records, for holding the kernel against the plain versions
def _record(trace, depth, members, right, sse):
    members = np.asarray(members, np.int64)
    trace.append((depth, tuple(members.tolist()),
                  tuple(members[np.asarray(right, bool)].tolist()),
                  float(sse)))


def _trace_fused(trace, depth, sg, side, sse, n_act):
    sidx = sg["sidx"].cpu().numpy()
    aslot = sg["aslot"].cpu().numpy()
    side = side.cpu().numpy()
    sse = sse.cpu().numpy()
    for a in range(n_act):
        rows = np.flatnonzero(aslot == a)
        _record(trace, depth, sidx[rows], side[rows], sse[a])


def compare_traces(got, want):
    """Splits of two runs, keyed by the cluster split: (number of splits
    of ``got`` that ``want`` did not make the same way, the first such
    split by depth as (depth, size, got SSE, want SSE or None when want
    never split that cluster))."""
    ref = {m: (r, s) for _, m, r, s in want}
    differ, first = 0, None
    for depth, m, r, s in sorted(got, key=lambda x: x[0]):
        w = ref.get(m)
        if w is None or w[0] != r:
            differ += 1
            if first is None:
                first = (depth, len(m), s, None if w is None else w[1])
    return differ, first


# ---------------------------------------------------------------------------
class _Node:
    __slots__ = ("id", "left", "right")

    def __init__(self, id=-1, left=None, right=None):
        self.id = id
        self.left = left
        self.right = right


def _embedding(dm, n_anchors):
    return np.ascontiguousarray(np.asarray(dm)[:, :n_anchors]
                                .astype(np.float32))


def build_tree_device(codes, dm: np.ndarray, n_anchors: int, device,
                      plain: bool = False, trace=None, counts=None):
    """kalign_tpu/tpu/kmeans.py::build_tree_device :141: the recursion one
    depth at a time; every cluster of 50 or more at a depth is split
    before any result is read, and each depth's assignments come back in
    one fetch.  On the CPU, or with plain=True, the splits run
    lloyd_batch in the reference's launch shapes (clusters bucketed by
    size into S_BUCKETS, extended by 8x past them, C_tile = 2^18 // S
    slots per launch); on the card one kernel launch takes every cluster
    of the depth, its members gathered back to back.  The splits are the
    span "tree.splits" of the record under way (utils/logging.py), the
    rest _finish_tree's (``counts`` as it takes it).  Returns (tasks
    [n-1, 3], seq_dist [n])."""
    device = torch.device(device)
    kernel = device.type == "cuda" and not plain
    n = len(codes)
    emb = _embedding(dm, n_anchors)
    emb_dev = torch.from_numpy(emb).to(device)
    T = MAX_TRIES
    s_buckets = list(S_BUCKETS)
    while s_buckets[-1] < n:
        s_buckets.append(s_buckets[-1] * 8)

    root = _Node()
    work = [(root, np.arange(n, dtype=np.int64))]
    upgma_jobs = []
    depth = 0
    with span("tree.splits"):
        while work:
            big = [(node, s) for node, s in work
                   if len(s) >= UPGMA_THRESHOLD]
            upgma_jobs.extend((node, s) for node, s in work
                              if len(s) < UPGMA_THRESHOLD)
            work = []
            if not big:
                break
            if kernel:
                results = _depth_kernel(emb_dev, big, T)
            else:
                results = _depth_plain(emb_dev, big, T, s_buckets)
            for (node, s), (right_mask, deg, sse) in zip(big, results):
                ns = len(s)
                if deg:
                    right_mask = np.arange(ns) >= ns // 2
                if trace is not None:
                    _record(trace, depth, s, right_mask, sse)
                node.left = _Node()
                node.right = _Node()
                work.append((node.left, s[~right_mask]))
                work.append((node.right, s[right_mask]))
            depth += 1
    with span("tree.upgma"):
        return _finish_tree(codes, dm, n_anchors, root, upgma_jobs, emb,
                            counts)


def _depth_plain(emb_dev, big, T, s_buckets):
    """One depth through lloyd_batch, group by group; per cluster its
    (right mask, degenerate, best SSE)."""
    dev = emb_dev.device
    groups = {}
    for k, (node, s) in enumerate(big):
        S = next(b for b in s_buckets if len(s) <= b)
        groups.setdefault(S, []).append(k)
    out = [None] * len(big)
    pending = []
    for S, ks in sorted(groups.items(), reverse=True):
        CT = _ctile(S)
        for g0 in range(0, len(ks), CT):
            # a launch of CT slots; slots past the group's clusters would
            # be empty and change no other slot's bits, so none is built
            grp = ks[g0:g0 + CT]
            C = len(grp)
            idx = np.zeros((C, S), np.int32)
            valid = np.zeros((C, S), bool)
            parity = np.zeros((C, S), np.int32)
            seeds = np.zeros((C, T), np.int32)
            n_tries = np.ones(C, np.int32)
            for c, k in enumerate(grp):
                s = big[k][1]
                ns = len(s)
                idx[c, :ns] = s
                valid[c, :ns] = True
                parity[c, :ns] = np.arange(ns) & 1
                tries = min(T, ns)
                seeds[c, :tries] = np.arange(tries) * (ns // tries)
                n_tries[c] = tries
            t = lambda x: torch.from_numpy(x).to(dev)
            pending.append((grp, lloyd_batch(
                emb_dev, t(idx), t(valid), t(parity), t(seeds), t(n_tries),
                T)))
    for grp, res in pending:
        assign, deg, sse = (x.cpu().numpy() for x in res)
        for c, k in enumerate(grp):
            ns = len(big[k][1])
            out[k] = (assign[c, :ns] == 1, bool(deg[c]), sse[c])
    return out


def _depth_kernel(emb_dev, big, T):
    """One depth through the kernel: the clusters' members back to back,
    one launch, the best tries picked on the card, one fetch."""
    dev = emb_dev.device
    sizes = np.array([len(s) for _, s in big], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    idx = torch.from_numpy(np.concatenate([s for _, s in big])).to(dev)
    rows = emb_dev[idx]
    st = torch.from_numpy(starts.astype(np.int32)).to(dev)
    sz = torch.from_numpy(sizes.astype(np.int32)).to(dev)
    assign, score, degen, _ = lloyd(rows, st, sz, form=0, T=T,
                                    max_size=int(sizes.max()))
    slot = torch.repeat_interleave(torch.arange(len(big), device=dev),
                                   sz.long())
    right, deg, sse = best_tries(assign, score, degen, slot)
    host = torch.cat([right.to(torch.int8), deg.to(torch.int8),
                      sse.view(torch.int32).view(torch.int8)]).cpu().numpy()
    N, C = int(sizes.sum()), len(big)
    right_h = host[:N] == 1
    deg_h = host[N:N + C] == 1
    sse_h = host[N + C:].view(np.float32)
    return [(right_h[starts[k]:starts[k] + sizes[k]], bool(deg_h[k]),
             sse_h[k]) for k in range(C)]


def build_tree_device_fused(codes, dm: np.ndarray, n_anchors: int, device,
                            plain: bool = False, depth_cap=None,
                            trace=None, counts=None):
    """kalign_tpu/tpu/kmeans.py::build_tree_device_fused :467: the
    recursion with membership on the device (fused_splits; the kernel on
    the card unless plain) and one fetch of the final path codes, from
    which the split tree is rebuilt.  Returns (tasks, seq_dist), or None
    when a cluster was still to split at depth_cap (default
    _FUSED_DEPTH_CAP; the caller then runs build_tree_device).  The
    splits up to the codes' fetch are the span "tree.splits", the rest
    _finish_tree's."""
    if depth_cap is None:
        depth_cap = _FUSED_DEPTH_CAP
    device = torch.device(device)
    kernel = device.type == "cuda" and not plain
    n = len(codes)
    with span("tree.splits"):
        emb = _embedding(dm, n_anchors)
        Np = _pow2_at_least(n)
        emb_pad = np.zeros((Np, n_anchors), np.float32)
        emb_pad[:n] = emb
        Ca = Np // UPGMA_THRESHOLD + 1
        cid_d, active_left = fused_splits(
            torch.from_numpy(emb_pad).to(device), n, Np, MAX_TRIES,
            depth_cap, Ca, kernel=kernel, trace=trace)
        if active_left:
            return None
        cid_h = cid_d.cpu().numpy()[:n]      # the one fetch of the codes

    # the split trie from the path codes (child 2c = left, 2c + 1 =
    # right); a run's members in ascending original index
    order = np.lexsort((np.arange(n), cid_h))
    bounds = np.flatnonzero(np.diff(cid_h[order])) + 1
    root = _Node()
    upgma_jobs = []
    for members in np.split(order, bounds):
        path = []
        cc = int(cid_h[members[0]])
        while cc != 1:
            path.append(cc)
            cc >>= 1
        node = root
        for cc in reversed(path):
            if node.left is None:
                node.left = _Node()
                node.right = _Node()
            node = node.left if (cc & 1) == 0 else node.right
        upgma_jobs.append((node, members.astype(np.int64)))
    with span("tree.upgma"):
        return _finish_tree(codes, dm, n_anchors, root, upgma_jobs, emb,
                            counts)


def _finish_tree(codes, dm, n_anchors, root, upgma_jobs, emb, counts=None):
    """kalign_tpu/tpu/kmeans.py::_finish_tree :234: native UPGMA below
    the threshold (native.build_tree on the cluster's rows of dm),
    internal nodes labelled in postorder, tasks emitted in preorder, and
    each sequence's mean anchor distance over its length, accumulated in
    float32 anchor by anchor.  The clusters' UPGMA runs on a thread per
    host core: the library keeps no state between calls and ctypes
    releases the interpreter lock while it runs, and each cluster's tree
    is its own, so the threads change no result.  ``counts`` takes the
    native trees' pair counts (native.TREE_COUNTS), summed."""
    n = len(codes)
    lens = np.array([len(c) for c in codes], np.int64)
    jobs = [(node, s) for node, s in upgma_jobs if len(s) > 1]

    def upgma(s):
        part = {}
        tasks_sub = native.build_tree([codes[int(i)] for i in s],
                                      np.ascontiguousarray(dm[s]), n_anchors,
                                      counts=part)[0]
        return tasks_sub, part
    native.lib()                  # built and loaded before the threads
    with ThreadPoolExecutor(max(1, min(len(jobs), os.cpu_count() or 1))) \
            as pool:
        subs, parts = zip(*pool.map(upgma, [s for _, s in jobs])) \
            if jobs else ((), ())
    if counts is not None:
        counts.update({key: sum(p[key] for p in parts)
                       for key in native.TREE_COUNTS})
    for node, s in upgma_jobs:
        if len(s) == 1:
            node.id = int(s[0])
    for (node, s), tasks_sub in zip(jobs, subs):
        ns = len(s)
        nodes = {i: _Node(id=int(s[i])) for i in range(ns)}
        for i in range(ns, 2 * ns - 1):
            nodes[i] = _Node()
        for a, b, c in tasks_sub:
            nodes[int(c)].left = nodes[int(a)]
            nodes[int(c)].right = nodes[int(b)]
        sub_root = nodes[2 * ns - 2]
        node.id = sub_root.id
        node.left = sub_root.left
        node.right = sub_root.right

    label = [n]

    def label_post(nd):
        if nd.left:
            label_post(nd.left)
        if nd.right:
            label_post(nd.right)
        if nd.id == -1:
            nd.id = label[0]
            label[0] += 1

    tasks: List[List[int]] = []

    def emit(nd):
        if nd.left and nd.right:
            tasks.append([nd.left.id, nd.right.id, nd.id])
        if nd.left:
            emit(nd.left)
        if nd.right:
            emit(nd.right)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 1000))
    try:
        label_post(root)
        emit(root)
    finally:
        sys.setrecursionlimit(old_limit)
    tasks = np.asarray(tasks, np.int32)
    assert len(tasks) == n - 1, (len(tasks), n)

    acc = np.zeros(n, np.float32)
    for j in range(n_anchors):
        acc = acc + emb[:, j]
    mean = acc / np.float32(n_anchors)
    seq_dist = np.where(lens > 0, mean / lens.astype(np.float32),
                        0.0).astype(np.float32)
    return tasks, seq_dist

