"""Prefix sums of the Gotoh kernels' scan transform.

Kernel: csrc/scan.cu (replaces the XLA cumsums feeding the TPU Gotoh
kernels, kalign_tpu/tpu/gotoh_pallas.py:309-338 and
gotoh_lanewise.py:334-341).

The prefix sums decide near-ties, so their order is part of the float
contract: left to right in float32, the order of numpy's cumsum (what
kalign_tpu's oracles use).  torch's CPU cumsum accumulates float32 in
double and its CUDA cumsum in a parallel order, so neither is used.
``prefix_sum_f32`` launches the kernel for CUDA tensors, so the vectors
never leave the card, and runs ``plain`` (numpy) for CPU tensors; both
give the same bits.
"""

import numpy as np
import torch

from kalign_tpu_torch.gpu import _cuda

launches = 0


def plain(x):
    """numpy's float32 cumsum along dim 1, on x's device."""
    out = np.cumsum(x.detach().cpu().numpy(), axis=1, dtype=np.float32)
    return torch.from_numpy(out).to(x.device)


def launch(x):
    """Launch csrc/scan.cu on a CUDA [R, W] float32 tensor whose rows are
    contiguous (any row stride)."""
    global launches
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("prefix_sum: a 2-d float32 CUDA tensor is required")
    if x.stride(1) != 1:
        x = x.contiguous()
    R, W = x.shape
    out = torch.empty((R, W), dtype=torch.float32, device=x.device)
    if R == 0 or W == 0:
        return out
    rc = _cuda.lib().kt_prefix_sum_f32(x.data_ptr(), x.stride(0), R, W,
                                       out.data_ptr(), _cuda.stream())
    _cuda.check(rc, "prefix_sum")
    launches += 1
    return out


def prefix_sum_f32(x):
    """Prefix sums along dim 1 of a [R, W] float32 tensor, accumulated
    left to right in float32: the kernel on CUDA, numpy on the CPU."""
    if x.is_cuda:
        return launch(x)
    if x.device.type == "cpu":
        return plain(x)
    raise ValueError(f"prefix_sum: unsupported device {x.device}")
