"""Traceback walk over the forward kernels' decision matrices.

Kernel: csrc/traceback.cu (replaces the device walk of
kalign_tpu/tpu/traceback.py: _walk :32, traceback_batch :114,
traceback_lanewise :128, which is XLA there, not Pallas).  Walking on the
card keeps a level's decision matrices in device memory; only the step
lists come back.

``walk_rows`` reads the row kernel's int8 [B, L1p, L2p] layout,
``walk_lanewise`` the lanewise kernel's [B, L2p/8, L1p4] nibble words.
Both return steps [B, max_steps] int8 in forward order padded with 3
(0 = match, 1 = gap in the rows, 2 = gap in the columns) and n [B] int32.
``walk_band`` walks one band of a column-sharded DP's decisions (the
columns col0 + 1 .. col0 + Wd, on the band's card) from a cell and state
to the band's left edge, and returns where it stopped: parallel/mesh.py
chains the bands' walks right to left.
CUDA tensors launch the kernel (one warp per walk over windows of the
decisions staged in shared memory; ``launch_plan`` sizes them); CPU
tensors run ``plain``, the same walk vectorised over the batch in
PyTorch.
"""

from collections import namedtuple

import torch

from kalign_tpu_torch.gpu import _cuda
from kalign_tpu_torch.gpu.gotoh_row import SMEM_LIMIT

DEC_A_MASK = 3
DEC_GA_EXT = 4
DEC_GB_EXT = 8
STEP_PAD = 3
PACK = 8
SMS = 132                  # streaming multiprocessors of an H100 SXM
# decision window staged per warp (rows x columns, one byte per cell), both
# layouts: small windows load fewer bytes that the walk never reads, at one
# device-memory round trip per 32 or more steps
WINDOW = (32, 32)
STEP_BUF_MAX = 4096        # step buffer per warp; longer walks flush
MAX_WARPS = 8

launches = 0

WalkLaunch = namedtuple("WalkLaunch", "warps win_rows win_cols buf smem")


def launch_plan(B: int, max_steps: int) -> WalkLaunch:
    """csrc/traceback.cu's launch: a step buffer of max_steps bytes (at
    least a window row and 16 more, at most STEP_BUF_MAX) and a window
    per warp, and enough warps per block to spread B walks over the
    SMs."""
    rows, cols = WINDOW
    buf = min(max(-(-max_steps // 16) * 16, cols + 16), STEP_BUF_MAX)
    per_warp = buf + rows * cols
    warps = max(1, min(MAX_WARPS, -(-B // SMS), SMEM_LIMIT // per_warp))
    return WalkLaunch(warps, rows, cols, buf, warps * per_warp)


def _fetch_rows(dec):
    bidx = torch.arange(dec.shape[0], device=dec.device)

    def fetch(r, c):
        return dec[bidx, r, c].to(torch.int64) & 0xFF
    return fetch


def _fetch_lanewise(dec):
    bidx = torch.arange(dec.shape[0], device=dec.device)

    def fetch(r, c):
        w = dec[bidx, c // PACK, r].to(torch.int64) & 0xFFFFFFFF
        return (w >> (4 * (c % PACK))) & 0xF
    return fetch


def plain(fetch, la, lb, st, max_steps: int, col0: int = 0,
          end: bool = False):
    """_walk (kalign_tpu/tpu/traceback.py:32-110) vectorised over the
    batch: the degenerate guards and the DP-column-0 rule included.  From
    (la, lb) in state st; with col0 > 0 each walk stops where its column
    reaches col0 (fetch then reads only columns >= col0).  With end, also
    returns each walk's last cell and state [B, 3] int32 (i, j, s)."""
    dev = la.device
    B = la.shape[0]
    i = la.to(torch.int64)
    j = lb.to(torch.int64)
    s = st.to(torch.int64)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    rev = torch.full((B, max_steps), STEP_PAD, dtype=torch.int64, device=dev)
    bidx = torch.arange(B, device=dev)
    for _ in range(max_steps):
        active = ((i > 0) | (j > 0)) & (n < max_steps)
        if col0:
            active &= j > col0
        if not bool(active.any()):
            break
        d = fetch(torch.clamp(i - 1, min=0), torch.clamp(j - 1, min=col0))
        d = torch.where(j > 0, d, torch.where(i > 1, DEC_GB_EXT, 0))
        s = torch.where((s == 0) & ((i == 0) | (j == 0)),
                        torch.where(j > 0, 1, 2), s)
        s = torch.where((s == 1) & (j == 0), 2, s)
        s = torch.where((s == 2) & (i == 0), 1, s)
        rev[bidx[active], n[active]] = s[active]
        in_a = s == 0
        in_ga = s == 1
        in_gb = s == 2
        ni = torch.where(in_a | in_gb, i - 1, i)
        nj = torch.where(in_a | in_ga, j - 1, j)
        ns = torch.where(in_a, d & DEC_A_MASK,
                         torch.where(in_ga,
                                     torch.where((d & DEC_GA_EXT) != 0, 1, 0),
                                     torch.where((d & DEC_GB_EXT) != 0, 2, 0)))
        i = torch.where(active, ni, i)
        j = torch.where(active, nj, j)
        s = torch.where(active, ns, s)
        n = n + active.to(torch.int64)
    idx = n[:, None] - 1 - torch.arange(max_steps, device=dev)[None, :]
    steps = torch.where(idx >= 0, rev.gather(1, idx.clamp(min=0)),
                        torch.full_like(rev, STEP_PAD))
    out = (steps.to(torch.int8), n.to(torch.int32))
    if end:
        out += (torch.stack([i, j, s], dim=1).to(torch.int32),)
    return out


def launch(lanewise: bool, dec, la, lb, st, max_steps: int, L1p: int,
           L2p: int, count_windows: bool = False, col0: int = 0,
           end: bool = False):
    """Launch csrc/traceback.cu on CUDA tensors; with count_windows, also
    return the windows each walk staged ([B] int32); col0 and end as in
    ``plain`` (end last)."""
    with torch.cuda.device(dec.device):
        return _launch(lanewise, dec, la, lb, st, max_steps, L1p, L2p,
                       count_windows, col0, end)


def _launch(lanewise, dec, la, lb, st, max_steps, L1p, L2p, count_windows,
            col0=0, end=False):
    global launches
    B = la.shape[0]
    _cuda.require_cuda("traceback", dec, la, lb, st)
    if (L2p % (PACK if lanewise else 16) or (lanewise and L1p % 4)
            or dec.data_ptr() % 16):
        raise ValueError(f"traceback: L2p={L2p} is not a multiple of "
                         f"{PACK if lanewise else 16}, the lanewise rows "
                         f"({L1p}) not of 4, or the decisions are not "
                         "16-byte aligned")
    steps = torch.empty((B, max_steps), dtype=torch.int8, device=la.device)
    n = torch.empty(B, dtype=torch.int32, device=la.device)
    win = torch.empty_like(n) if count_windows else None
    cell = torch.empty((B, 3), dtype=torch.int32, device=la.device) \
        if end else None
    out = (steps, n) + ((win,) if count_windows else ()) + \
        ((cell,) if end else ())
    if B == 0:
        return out
    plan = launch_plan(B, max_steps)
    rc = _cuda.lib().kt_traceback(
        int(lanewise), dec.data_ptr(), la.data_ptr(), lb.data_ptr(),
        st.data_ptr(), B, L1p, L2p, max_steps, plan.warps, plan.win_rows,
        plan.win_cols, plan.buf, steps.data_ptr(), n.data_ptr(),
        win.data_ptr() if count_windows else None, int(col0),
        cell.data_ptr() if end else None, _cuda.stream(dec.device))
    _cuda.check(rc, "traceback")
    launches += 1
    return out


def _walk(lanewise, dec, la, lb, st, max_steps, L1p, L2p, fetch):
    st = st.to(torch.int32)
    if dec.is_cuda:
        return launch(lanewise, dec.contiguous(), la, lb, st.contiguous(),
                      max_steps, L1p, L2p)
    if dec.device.type == "cpu":
        return plain(fetch, la, lb, st, max_steps)
    raise ValueError(f"traceback: unsupported device {dec.device}")


def walk_rows(dec, la, lb, st, max_steps: int):
    """dec [B, L1p, L2p] int8 (row r = DP row r+1, col c = DP col c+1)."""
    _, L1p, L2p = dec.shape
    return _walk(False, dec, la, lb, st, max_steps, L1p, L2p,
                 _fetch_rows(dec))


def walk_lanewise(dec, la, lb, st, max_steps: int):
    """dec [B, L2p/8, L1p4] int32 nibble words (gotoh_lanewise layout,
    rows padded to a multiple of 4)."""
    _, W8, L1p4 = dec.shape
    return _walk(True, dec, la, lb, st, max_steps, L1p4, W8 * PACK,
                 _fetch_lanewise(dec))


def _fetch_band(dec, col0: int):
    bidx = torch.arange(dec.shape[0], device=dec.device)

    def fetch(r, c):
        return dec[bidx, r, c - col0].to(torch.int64) & 0xFF
    return fetch


def walk_band(dec, cell, col0: int, max_steps: int):
    """One walk over one band of a column-sharded DP: dec [1, L1p, Wd]
    int8, the row kernel's layout of the DP columns col0 + 1 .. col0 + Wd
    (Wd a multiple of 16); cell [3] int32 on dec's device, the cell (i, j)
    and state to start at (j within the band, or, on row 0, anywhere right
    of col0).  The walk stops where its column reaches col0 (never, with
    col0 0).  Returns steps [1, max_steps] int8 (this band's part of the
    path in forward order, padded with 3), n [1] int32 and the cell and
    state where it stopped [1, 3] int32 (i, j, s: the band to the left
    starts there).  The kernel on CUDA tensors, ``plain`` on CPU ones."""
    _, L1p, Wd = dec.shape
    la, lb, st = (cell[k:k + 1].to(torch.int32) for k in range(3))
    if dec.is_cuda:
        return launch(False, dec.contiguous(), la.contiguous(),
                      lb.contiguous(), st.contiguous(), max_steps, L1p, Wd,
                      col0=col0, end=True)
    if dec.device.type == "cpu":
        return plain(_fetch_band(dec, col0), la, lb, st, max_steps, col0,
                     end=True)
    raise ValueError(f"traceback: unsupported device {dec.device}")


def plain_rows(dec, la, lb, st, max_steps: int):
    """The plain walk of walk_rows on any device."""
    return plain(_fetch_rows(dec), la, lb, st.to(torch.int32), max_steps)


def plain_lanewise(dec, la, lb, st, max_steps: int):
    """The plain walk of walk_lanewise on any device."""
    return plain(_fetch_lanewise(dec), la, lb, st.to(torch.int32), max_steps)
