"""Match preparation: the centering bias and the consistency bonus added
to a block of a batch's match scores.

Kernel: csrc/prepare_match.cu (replaces kalign_tpu/tpu/engine.py::
_prepare_match :71, an XLA fusion); the note at the top of the CUDA
source gives its design and what bounds it.  ``prepare_match`` updates a
CUDA block in place through the kernel and runs ``bonus_match`` — the
same arithmetic in PyTorch, in the float order of kalign_tpu's
_prepare_match — for CPU tensors.

A block is the rows [row0, row0 + R) and the columns [col0, col0 + W) of
the whole match [B, L1p, L2p]: the bias takes the whole match's
coordinates, so a row block of the wave route (gpu/gotoh_wave.py) or a
band of the mesh (parallel/mesh.py::long_operands) gets the bits of the
same cells of the whole match.  The bonus is the compact tuple (per_w,
apos_r [B, K, R], conf_r [B, K, R], apos_c [B, K, W], conf_c [B, K, W]),
its vectors cut to the block (``cut``), per_w a float32 scalar tensor.
"""

from collections import namedtuple

import torch

from kalign_tpu_torch.gpu import _cuda

launches = 0

# the kernel's tile (csrc/prepare_match.cu kThreads, kCols, kMaxRows)
THREADS = 256
COLS = 4
MAX_ROWS = 64
# blocks that fill the card: two resident an SM (the kernel's
# __launch_bounds__) on an H100's 132 SMs, twice over
FILL_BLOCKS = 2 * 2 * 132
# rows a tile at least: at a serve launch (8 x 384 x 384) tiles of 4
# rows took 0.0103 ms on an H100, of 16 rows 0.0071, of 32 0.0081 (the
# card half idle, the launch's own cost counts more; PERF.md, PR 16)
MIN_ROWS = 16

# a launch: tx threads across a tile of tx * COLS columns, ``rows`` rows
# a tile, the grid (column tiles x row tiles, B)
Plan = namedtuple("Plan", "tx rows ctiles rtiles")


def launch_plan(B: int, R: int, W: int) -> Plan:
    """The kernel's tiles for a block [B, R, W]: tx the least power of two
    from 32 that covers W's float4s, at most THREADS; ``rows`` from
    MAX_ROWS down by halves, while the grid has fewer than FILL_BLOCKS
    blocks, to no fewer than MIN_ROWS (nor the tile's threads down,
    THREADS / tx)."""
    quads = -(-W // COLS)
    tx = 32
    while tx < THREADS and tx < quads:
        tx *= 2
    ctiles = -(-quads // tx)
    least = max(THREADS // tx, MIN_ROWS)
    rows = MAX_ROWS
    while rows > least and B * ctiles * -(-R // rows) < FILL_BLOCKS:
        rows //= 2
    return Plan(tx, rows, ctiles, -(-R // rows))


def bonus_match(match, la, lb, bias_eps, bonus, col0: int = 0,
                row0: int = 0):
    """The plain version: centering bias and consistency bonus added to a
    block of the match on its device, in the float order of kalign_tpu's
    _prepare_match (tpu/engine.py:71-100): the bias in the form
    |j - i*slope| * eps, then the bonus accumulated anchor by anchor into
    zeros and added once.  Returns a new tensor."""
    B, R, W = match.shape
    dev = match.device
    slope = lb.to(torch.float32) / torch.clamp(la.to(torch.float32), min=1.0)
    ii = torch.arange(row0 + 1, row0 + R + 1,
                      device=dev).to(torch.float32)[None, :, None]
    jj = torch.arange(col0 + 1, col0 + W + 1,
                      device=dev).to(torch.float32)[None, None, :]
    dev_ = torch.abs(jj - ii * slope[:, None, None])
    match = match - dev_ * bias_eps[:, None, None]
    per_w, apr, cfr, apc, cfc = bonus
    acc = torch.zeros_like(match)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k in range(apr.shape[1]):
        eq = (apr[:, k, :, None] == apc[:, k, None, :]) & \
            (apr[:, k, :, None] >= 0)
        term = (per_w * cfr[:, k, :, None]) * cfc[:, k, None, :]
        acc = acc + torch.where(eq, term, zero)
    return match + acc


def cut(bonus, r0: int, r1: int, c0: int = 0, c1=None):
    """The bonus of the rows [r0, r1) and the columns [c0, c1) of the
    whole match."""
    per_w, apr, cfr, apc, cfc = bonus
    return (per_w, apr[:, :, r0:r1], cfr[:, :, r0:r1], apc[:, :, c0:c1],
            cfc[:, :, c0:c1])


def _aligned(x):
    """x, or a copy where its data is not 16-byte aligned (a view at an
    offset)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch(match, la, lb, bias_eps, bonus, col0: int = 0, row0: int = 0):
    """csrc/prepare_match.cu on a CUDA block, in place; returns it."""
    global launches
    B, R, W = match.shape
    per_w, apr, cfr, apc, cfc = bonus
    K = apr.shape[1]
    if match.dtype != torch.float32 or not match.is_contiguous():
        raise ValueError("prepare_match: a contiguous float32 match block")
    if tuple(apr.shape) != (B, K, R) or tuple(apc.shape) != (B, K, W):
        raise ValueError("prepare_match: the bonus vectors are not the "
                         "block's")
    if W % COLS or match.data_ptr() % 16:
        raise ValueError("prepare_match: the block's rows must be whole "
                         "float4s (W a multiple of 4, 16-byte aligned)")
    plan = launch_plan(B, R, W)
    dev = match.device
    with torch.cuda.device(dev):
        slope = (lb.to(torch.float32)
                 / torch.clamp(la.to(torch.float32), min=1.0)).contiguous()
        # the kernel reads the columns' vectors as 16-byte words
        vecs = [_aligned(x.contiguous()) for x in (
            bias_eps.to(torch.float32), per_w.to(torch.float32).reshape(1),
            apr.to(torch.int32), cfr.to(torch.float32),
            apc.to(torch.int32), cfc.to(torch.float32))]
        _cuda.require_cuda("prepare_match", match, slope, *vecs)
        rc = _cuda.lib().kt_prepare_match(
            match.data_ptr(), slope.data_ptr(),
            *(x.data_ptr() for x in vecs), B, K, R, W, row0, col0,
            plan.tx, plan.rows, _cuda.stream(dev))
    _cuda.check(rc, "prepare_match")
    launches += 1
    return match


def prepare_match(match, la, lb, bias_eps, bonus, col0: int = 0,
                  row0: int = 0):
    """The kernel on a CUDA block (in place), the plain version on a CPU
    one; returns the prepared block."""
    if match.is_cuda:
        return launch(match, la, lb, bias_eps, bonus, col0, row0)
    if match.device.type == "cpu":
        return bonus_match(match, la, lb, bias_eps, bonus, col0, row0)
    raise ValueError(f"prepare_match: unsupported device {match.device}")
