"""The exact engine's segmented anti-diagonal wavefront sweep.

Kernel: csrc/exact_sweep.cu (replaces the XLA device program of
kalign_tpu/tpu/exact.py, ``_sweep_one`` :65 vmapped by ``_sweep_batch``
:163; not a Pallas kernel).  One launch sweeps G grids of VR virtual rows
x C+1 columns.  Each Hirschberg window of the exact engine occupies a
band of virtual rows: one init row (the reference's pre-loop boundary
initialisation) and its processed rows; per-cell penalties arrive as
per-row and per-column addends, the backward windows in column-reversed
coordinates (gpu/exact.py builds the plans).  Cell (vr, j) reads
(vr, j-1), (vr-1, j) and (vr-1, j-1) only, and each cell repeats the
reference row sweep's scalar float32 operations in their order, so the
states are bit-identical to the native runtime's.

Schedules.  The reference runs row vr at column j = d - vr at step d, so
a grid takes VR + C + 1 steps whatever its windows.  The kernel runs the
band-local schedule (``schedule``): row vr reaches column 0 at step
lag[vr] = (vr - its band's init row) - startq, so every band starts at
step 0 on its own first column and a grid takes as many steps as its
tallest band plus its widest column span.  Only the step at which a cell
is computed changes: a processed row reads only its own band (the init
row reads no row above), so every cell reads the same three neighbours
with the same values.  Rows past one block's registers are swept in
strips of ``launch_plan``'s rows, one after another, each strip's last
row carried to the next through a global buffer.

The plan is a dict of tensors with a leading grid axis G (the keys of
``PLAN_KEYS``, in the reference's layout: the column arrays ``*_p`` and
``p2sub_p`` reversed and padded with VR zeros on each side).  ``match``
and ``bonus`` may be narrower than C+1 columns: the columns past their
width hold zeros, as the reference's plans do past each problem's width.
The kernel also takes the schedule (``lag`` [G, VR] and ``span``
[G, strips, 2]); the engine computes it on the host and uploads it with
the plan's rows, and ``launch`` computes it when the plan has none.

``sweep`` launches the kernel for CUDA tensors and runs ``plain`` for CPU
tensors; ``plain`` follows ``_sweep_one`` operation for operation (shift1
with NEG fill, colvals on the reversed padded arrays, the maxima in the
same nesting, the descending c = 22..0 mul-add chain, the selects in the
same order, the max-scatter of final rows into a -inf output), on the
reference's schedule.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kalign_tpu_torch.gpu import _cuda

NEG = float(np.float32(-3.4028234663852886e38))   # -FLT_MAX
NSUB = 23

ROW_BOOL = ("is_init", "is_final", "active", "init_tg", "start_tg",
            "end_tg")
ROW_INT = ("startq", "endq", "win_slot")
ROW_F32 = ("seedA", "seedGA", "seedGB", "gb_ext", "gb_open", "gb_tg", "dgb")
COL_F32 = ("ga_ext_p", "ga_open_p", "ga_tg_p", "dga_p")
PLAN_KEYS = (ROW_BOOL + ROW_INT + ROW_F32 + COL_F32
             + ("match", "bonus", "p1cnt", "p2sub_p"))

# the kernel's block (csrc/exact_sweep.cu): up to THREADS threads of at
# most ROWS consecutive rows each, their constants and state in
# registers; taller grids are swept in strips of THREADS x ROWS rows.  One
# row a thread measured fastest (PERF.md §6: more rows a thread keep
# more match rows in flight than L1 holds); the kernel also takes 2 and 4
# (2 in chain form), for scripts/sweep_settings.py
THREADS = 512
ROWS = 1

launches = 0


class SweepLaunch(NamedTuple):
    threads: int     # threads per block (one block per grid)
    rows: int        # consecutive rows per thread
    strips: int      # strips of threads x rows rows, swept in turn


def launch_plan(VR: int) -> SweepLaunch:
    """The kernel's block for VR virtual rows, a power of two: one thread
    per row up to THREADS rows (ROWS a thread up to THREADS x ROWS), then
    strips of THREADS x ROWS rows."""
    if VR < 1 or VR & (VR - 1):
        raise ValueError(f"exact_sweep: VR = {VR} is not a power of two")
    threads = min(VR, THREADS)
    rows = min(VR // threads, ROWS)
    return SweepLaunch(threads, rows, VR // (threads * rows))


def live_steps(VR: int, C: int, ncols: int) -> int:
    """Steps of the reference's schedule that reach the output columns
    below ncols: a cell (vr, j) runs at step vr + j and reads only
    columns <= j."""
    return min(VR + C + 1, VR + ncols)


def schedule(plan, ncols: int, strip: int = None, band_local: bool = True):
    """The kernel's schedule of a plan (numpy arrays or CPU tensors of
    [G, VR] rows): (lag, span).  Row vr computes column j = d - lag[vr] at
    step d; span [G, VR // strip, 2] holds each strip's first step and
    the step past its last, the fewest that reach every in-window cell
    below ncols (0, 0 for a strip with none).  band_local=False gives the
    reference's schedule, lag = vr (one strip: strip = VR)."""
    arr = lambda k: np.asarray(plan[k].cpu() if torch.is_tensor(plan[k])
                               else plan[k])
    startq = arr("startq").astype(np.int32, copy=False)
    endq = arr("endq").astype(np.int32, copy=False)
    G, VR = startq.shape
    strip = VR if strip is None else strip
    vr = np.arange(VR, dtype=np.int32)
    if band_local:
        # a row's first cell at the rows since its band's init row (the
        # last init row at or above)
        lo = vr - np.maximum.accumulate(np.where(arr("is_init"), vr, 0),
                                        axis=1)
    else:
        lo = vr + startq
    lag = lo - startq
    hi = lag + np.minimum(endq, ncols - 1)      # its last one below ncols
    live = arr("active") & (hi >= lo)
    lo = np.where(live, lo, np.iinfo(np.int32).max).reshape(G, -1, strip)
    hi = np.where(live, hi, -1).reshape(G, -1, strip)
    d0, d1 = lo.min(axis=2), hi.max(axis=2) + 1
    empty = d1 <= d0
    span = np.stack([np.where(empty, 0, d0), np.where(empty, 0, d1)], -1)
    return lag.astype(np.int32, copy=False), span.astype(np.int32)


def steps_run(span) -> int:
    """Steps of the launch's longest block (its strips' steps added)."""
    span = np.asarray(span)
    return int((span[..., 1] - span[..., 0]).sum(axis=-1).max(initial=0))


def _padded(x, width: int):
    """[G, VR, w] zero-extended to [G, VR, width]."""
    if x.shape[-1] == width:
        return x
    out = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype,
                      device=x.device)
    out[..., :x.shape[-1]] = x
    return out


def plain(plan, VR: int, C: int, Wmax: int, use_chain: bool,
          steps: int = None):
    """The reference sweep (kalign_tpu/tpu/exact.py::_sweep_one) on every
    grid of the plan at once: out [G, Wmax, C+1, 3] float32 holding each
    window's final row (A, GA, GB), -inf elsewhere.  ``steps`` runs only
    the first anti-diagonals (live_steps: the columns below its ncols are
    then complete).  The three states travel stacked as [3, G, VR] where
    the reference applies one operation to each of them alike (the
    shifts and the final selects)."""
    p = plan
    dev = p["seedA"].device
    G = p["seedA"].shape[0]
    f32 = torch.float32
    vr_idx = torch.arange(VR, dtype=torch.int32, device=dev)
    D = VR + C + 1 if steps is None else steps
    neg = torch.full((G, VR), NEG, dtype=f32, device=dev)
    neg3 = torch.full((3, G, 1), NEG, dtype=f32, device=dev)
    ninf = torch.full((G, VR, 3), float("-inf"), dtype=f32, device=dev)
    match = _padded(p["match"], C + 1)
    bonus = _padded(p["bonus"], C + 1)
    is_init, is_final, active = p["is_init"], p["is_final"], p["active"]
    init_tg, start_tg, end_tg = p["init_tg"], p["start_tg"], p["end_tg"]
    startq, endq = p["startq"], p["endq"]
    seedA, seedGA, seedGB = p["seedA"], p["seedGA"], p["seedGB"]
    gb_ext, gb_open, gb_tg, dgb = (p["gb_ext"], p["gb_open"], p["gb_tg"],
                                   p["dgb"])
    if use_chain:
        p1cnt_t = p["p1cnt"].permute(2, 0, 1).contiguous()
        p2sub_t = p["p2sub_p"].permute(2, 0, 1).contiguous()
    slot_base = p["win_slot"].long() * (C + 1)
    drop = Wmax * (C + 1)

    def shift1(x):
        # index vr-1 with NEG fill (vr = 0 has no up-neighbour)
        return torch.cat([neg3, x[:, :, :-1]], dim=2)

    def colvals(arr_pad, d):
        # arr_pad = pad(arr[::-1], VR both sides); arr[d - vr] at lane vr
        return arr_pad[:, C - d + VR:C - d + 2 * VR]

    S1 = S2 = torch.full((3, G, VR), NEG, dtype=f32, device=dev)
    out = torch.full((G, Wmax + 1, C + 1, 3), float("-inf"), dtype=f32,
                     device=dev)
    out_flat = out.view(G, (Wmax + 1) * (C + 1), 3)
    for d in range(D):
        jv = d - vr_idx
        jc = torch.clamp(jv, 0, C)
        inwin = active & (jv >= startq) & (jv <= endq)

        A_l, GA_l = S1[0], S1[1]                          # (vr, j-1)
        A_u, GA_u, GB_u = shift1(S1)                      # (vr-1, j)
        A_d, GA_d, GB_d = shift1(S2)                      # (vr-1, j-1)

        ga_ext = colvals(p["ga_ext_p"], d)
        ga_open = colvals(p["ga_open_p"], d)
        ga_tg = colvals(p["ga_tg_p"], d)
        dga = colvals(p["dga_p"], d)
        jcl = jc.long()
        match_d = match[:, vr_idx, jcl]
        bonus_d = bonus[:, vr_idx, jcl]

        at_start = jv == startq
        at_end = jv == endq

        # init rows (reference pre-loop boundary init)
        ga_chain = torch.maximum(GA_l + ga_ext, A_l + ga_open)
        ga_chain_tg = torch.maximum(GA_l, A_l) + ga_tg
        iA = torch.where(at_start, seedA, neg)
        iGA = torch.where(at_start, seedGA,
                          torch.where(at_end, neg,
                                      torch.where(init_tg, ga_chain_tg,
                                                  ga_chain)))
        iGB = torch.where(at_start, seedGB, neg)

        # processed rows
        a_int = torch.maximum(torch.maximum(A_d, GA_d + dga), GB_d + dgb)
        if use_chain:
            # profile x profile match: sequential mul-add chain in
            # descending residue order (aln_profileprofile.c:114-117)
            # (the 23 products are taken at once, residue-major: each is
            # the same IEEE product; the adds stay one by one)
            prod = p1cnt_t * p2sub_t[:, :, C - d + VR:C - d + 2 * VR]
            for c in range(NSUB - 1, -1, -1):
                a_int = a_int + prod[c]
        else:
            a_int = a_int + match_d
        a_int = a_int + bonus_d
        pA = torch.where(at_start, neg, a_int)
        pGA = torch.where(at_start | at_end, neg, ga_chain)
        gb_std = torch.maximum(GB_u + gb_ext, A_u + gb_open)
        gb_tgv = torch.maximum(GB_u, A_u) + gb_tg
        pGB = torch.where(at_start,
                          torch.where(start_tg, gb_tgv, gb_std),
                          torch.where(at_end,
                                      torch.where(end_tg, gb_tgv, gb_std),
                                      gb_std))

        # (nA, nGA, nGB)
        N = torch.where(inwin, torch.where(is_init, torch.stack([iA, iGA,
                                                                 iGB]),
                                           torch.stack([pA, pGA, pGB])),
                        neg)

        # capture band-final rows into the per-window output
        fin = is_final & inwin
        vals = torch.where(fin[..., None], N.permute(1, 2, 0), ninf)
        idx = torch.where(fin, slot_base, drop) + jcl
        out_flat.scatter_reduce_(1, idx.unsqueeze(-1).expand(G, VR, 3),
                                 vals, reduce="amax")

        S1, S2 = N, S1
    return out[:, :Wmax]


def operands(p, VR: int, C: int, use_chain: bool):
    """The kernel's packed operands of a plan: per row one int4 (flags,
    startq, endq, slot) and 8 floats (rowi, rowf); per column
    (unreversed) ga_ext, ga_open, ga_tg, dga (cols) and the 23 p2sub
    values (p2sub; cols in match form)."""
    flags = sum(p[k].to(torch.int32) << b for b, k in enumerate(ROW_BOOL))
    rowi = torch.stack([flags] + [p[k].to(torch.int32) for k in ROW_INT],
                       dim=-1).contiguous()
    rowf = torch.stack([p[k].float() for k in ROW_F32]
                       + [torch.zeros_like(p["seedA"])], dim=-1).contiguous()
    cols = torch.stack([p[k][:, VR:VR + C + 1].flip(1) for k in COL_F32],
                       dim=-1).contiguous()
    p2sub = (p["p2sub_p"][:, VR:VR + C + 1].flip(1).contiguous()
             if use_chain else cols)
    return rowi, rowf, cols, p2sub


def launch(plan, VR: int, C: int, Wmax: int, use_chain: bool, W: int,
           ncols: int):
    """Launch csrc/exact_sweep.cu on a plan of CUDA tensors: out
    [G, W, ncols, 3] float32, the first W windows' first ncols columns of
    ``plain``'s output.  The schedule is the plan's ``lag`` and ``span``
    where it has them (``schedule`` at launch_plan's strip and ncols),
    else computed here from its rows.  Raises on a refused launch."""
    with torch.cuda.device(plan["seedA"].device):
        return _launch(plan, VR, C, Wmax, use_chain, W, ncols)


def _launch(plan, VR, C, Wmax, use_chain, W, ncols):
    global launches
    p = plan
    dev = p["seedA"].device
    _cuda.require_cuda("exact_sweep", *(p[k] for k in PLAN_KEYS))
    G = p["seedA"].shape[0]
    lp = launch_plan(VR)
    if not 0 < W <= Wmax or not 0 < ncols <= C + 1:
        raise ValueError(f"exact_sweep: live window ({W}, {ncols}) outside "
                         f"({Wmax}, {C + 1})")
    ldm = p["match"].shape[-1]
    if p["bonus"].shape[-1] != ldm or not 0 < ldm <= C + 1:
        raise ValueError("exact_sweep: match and bonus must share a width "
                         "of at most C + 1")
    if "lag" in p:
        lag, span = p["lag"], p["span"]
    else:
        lag, span = (torch.from_numpy(x).to(dev) for x in schedule(
            p, ncols, lp.threads * lp.rows))
    if span.shape != (G, lp.strips, 2):
        raise ValueError(f"exact_sweep: a schedule of {tuple(span.shape)} "
                         f"for {lp.strips} strips")
    _cuda.require_cuda("exact_sweep", lag, span)
    rowi, rowf, cols, p2sub = operands(p, VR, C, use_chain)
    out = torch.full((G, W, ncols, 3), float("-inf"), dtype=torch.float32,
                     device=dev)
    # a strip's last row, carried to the next strip: [G, 2, 3, C + 1]
    edge = (torch.empty((G, 2, 3, C + 1), dtype=torch.float32, device=dev)
            if lp.strips > 1 else None)
    rc = _cuda.lib().kt_exact_sweep(
        rowi.data_ptr(), rowf.data_ptr(), cols.data_ptr(),
        p["match"].data_ptr(), p["bonus"].data_ptr(),
        p["p1cnt"].data_ptr(), p2sub.data_ptr(), lag.data_ptr(),
        span.data_ptr(), out.data_ptr(),
        None if edge is None else edge.data_ptr(),
        G, VR, C, ldm, W, ncols, lp.strips, int(bool(use_chain)),
        lp.threads, lp.rows, ctypes.c_void_p(_cuda.stream(dev)))
    _cuda.check(rc, "exact_sweep")
    launches += 1
    return out


def sweep(plan, VR: int, C: int, Wmax: int, use_chain: bool, live=None):
    """Every grid of the plan swept: out [G, W, ncols, 3] with live =
    (W, ncols), the windows and columns the caller reads (default all:
    (Wmax, C + 1)).  The kernel for CUDA tensors, ``plain`` for CPU
    tensors."""
    W, ncols = live if live is not None else (Wmax, C + 1)
    if plan["seedA"].device.type == "cpu":
        return plain(plan, VR, C, Wmax, use_chain,
                     live_steps(VR, C, ncols))[:, :W, :ncols]
    return launch(plan, VR, C, Wmax, use_chain, W, ncols)
