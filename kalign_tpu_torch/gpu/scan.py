"""Prefix sums of the Gotoh kernels' scan transform.

Kernel: csrc/scan.cu (replaces the XLA cumsums feeding the TPU Gotoh
kernels, kalign_tpu/tpu/gotoh_pallas.py:309-338 and
gotoh_lanewise.py:334-341).

The prefix sums decide near-ties, so their order is part of the float
contract: left to right in float32, the order of numpy's cumsum (what
kalign_tpu's oracles use).  torch's CPU cumsum accumulates float32 in
double and its CUDA cumsum in a parallel order, so neither is used.
``prefix_sums_f32`` takes several row sets in one launch of the kernel
for CUDA tensors, so the vectors never leave the card, and runs ``plain``
(numpy) on each set for CPU tensors; both give the same bits.
"""

import ctypes

import numpy as np
import torch

from kalign_tpu_torch.gpu import _cuda

MAX_SETS = 4       # row sets one launch takes (csrc/scan.cu kMaxSets)

launches = 0


def plain(x):
    """numpy's float32 cumsum along dim 1, on x's device."""
    out = np.cumsum(x.detach().cpu().numpy(), axis=1, dtype=np.float32)
    return torch.from_numpy(out).to(x.device)


def _rows_contiguous(x):
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("prefix_sum: 2-d float32 tensors are required")
    return x if x.stride(1) == 1 or x.shape[1] <= 1 else x.contiguous()


def descriptors(sets):
    """csrc/scan.cu's int64 descriptors of (input, output) pairs: input
    address, its row stride, rows, columns, output address."""
    desc = []
    for x, o in sets:
        desc += [x.data_ptr(), x.stride(0), x.shape[0], x.shape[1],
                 o.data_ptr()]
    return desc


def launch(*xs):
    """Launch csrc/scan.cu once on up to MAX_SETS CUDA [R, W] float32
    tensors whose rows are contiguous (any row stride); returns one
    contiguous output per input."""
    global launches
    if not xs or len(xs) > MAX_SETS:
        raise ValueError(f"prefix_sum: 1 to {MAX_SETS} tensors per launch")
    if not all(x.is_cuda for x in xs):
        raise ValueError("prefix_sum: CUDA tensors are required")
    xs = [_rows_contiguous(x) for x in xs]
    outs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for x in xs]
    sets = [(x, o) for x, o in zip(xs, outs) if x.numel()]
    if not sets:
        return tuple(outs)
    desc = descriptors(sets)
    dev = sets[0][0].device
    if any(x.device != dev for x, _ in sets):
        raise ValueError("prefix_sum: all tensors on one CUDA device")
    with torch.cuda.device(dev):
        rc = _cuda.lib().kt_prefix_sums_f32(
            len(sets), (ctypes.c_longlong * len(desc))(*desc),
            _cuda.stream(dev))
    _cuda.check(rc, "prefix_sum")
    launches += 1
    return tuple(outs)


def prefix_sums_f32(*xs):
    """Prefix sums along dim 1 of each [R, W] float32 tensor, accumulated
    left to right in float32: one kernel launch on CUDA, numpy per tensor
    on the CPU."""
    if all(x.is_cuda for x in xs):
        return launch(*xs)
    if all(x.device.type == "cpu" for x in xs):
        return tuple(plain(_rows_contiguous(x)) for x in xs)
    raise ValueError("prefix_sum: all tensors on one CUDA device or all "
                     "on the CPU")


def prefix_sum_f32(x):
    """prefix_sums_f32 of one tensor."""
    return prefix_sums_f32(x)[0]
