"""Problem-per-lane Gotoh forward with the match computed in the kernel.

Kernel: csrc/gotoh_lanewise.cu, the FusedOperands instantiation
(replaces the TPU kernel kalign_tpu/tpu/gotoh_lanewise.py::_fused_kernel,
gotoh_forward_fused:692).  It is the lanewise DP of gotoh_lanewise.py,
one DP body for both, except that no [B, L1p, L2p] match array exists:
the kernel computes each cell's score from the operands the engine would
otherwise multiply,

    m(i, j) = X[i, 0] * Y[j, 0] + X[i, 1] * Y[j, 1] + ...
              + X[i, nc-1] * Y[j, nc-1]

left to right in c, every multiply and add rounded on its own (the
library builds with -fmad=false).  ``plain`` builds the same chain with
float32 torch ops and runs gotoh_lanewise.plain on it, so kernel and
plain version agree bitwise on any data.  On operands whose partial sums
are exact (one-hot or integer counts against an integer substitution
matrix, as for DNA under kalign's nucleotide models) the chain also
equals any matrix product, so this route then gives the same bits as
``torch.bmm`` followed by the match-stream lanewise kernel.

Operands: lhs [B, L1p, nc] and rhs [B, L2p, nc] float32, contiguous, the
engine's operands sliced to the live alphabet (exact: the counts side
is zero beyond it, so the dropped terms of the chain are zeros).
Penalties, lengths, bias and outputs as gotoh_lanewise.forward (packed
[B, L2p/8, L1p4] nibble decisions; walk them with
traceback.walk_lanewise).
"""

import torch

from kalign_tpu_torch.gpu import _cuda, gotoh_lanewise
from kalign_tpu_torch.gpu.gotoh_row import pick_dp, run_dp

MAX_NC = 32        # the widest operand row the kernel holds in registers

launches = 0

prepare = gotoh_lanewise.prepare


def chain_match(lhs, rhs):
    """The kernel's match: [B, L1p, L2p] from the ascending-c chain."""
    m = lhs[:, :, None, 0] * rhs[:, None, :, 0]
    for c in range(1, lhs.shape[2]):
        m = m + lhs[:, :, None, c] * rhs[:, None, :, c]
    return m


def plain(lhs, rhs, prep, la, lb):
    """The kernel's arithmetic in PyTorch."""
    return gotoh_lanewise.plain(chain_match(lhs, rhs), prep, la, lb)


def launch(lhs, rhs, prep, la, lb):
    """Launch the fused instantiation of csrc/gotoh_lanewise.cu on CUDA
    tensors."""
    global launches
    B, L1p, nc = lhs.shape
    L2p = rhs.shape[1]
    if rhs.shape != (B, L2p, nc):
        raise ValueError(f"fused Gotoh kernel: operands {tuple(lhs.shape)} "
                         f"and {tuple(rhs.shape)} disagree")
    if not 1 <= nc <= MAX_NC:
        raise ValueError(f"fused Gotoh kernel: nc={nc} is outside "
                         f"1..{MAX_NC}")
    if L2p % gotoh_lanewise.PACK:
        raise ValueError(f"fused Gotoh kernel: L2p={L2p} is not a multiple "
                         f"of {gotoh_lanewise.PACK}")
    if lhs.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise ValueError("fused Gotoh kernel: float32 operands are required")
    with torch.cuda.device(lhs.device):
        _cuda.require_cuda("gotoh_fused", lhs, rhs, prep["colpen"],
                           prep["cols_eps"], prep["rowpen"],
                           prep["row_term"], prep["gb0"], prep["ga0"], la,
                           lb)
    out = gotoh_lanewise.launch_kernel(
        "kt_gotoh_fused_forward", "gotoh_fused",
        (lhs.data_ptr(), rhs.data_ptr(), nc), B, L1p, L2p, nc, prep, la, lb)
    if B:
        launches += 1
    return out


def forward(lhs, rhs, pens_cols, pens_rows, la, lb, slope=None,
            bias_eps=None):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    dp = pick_dp("gotoh_fused", lhs, launch, plain)
    return run_dp(prepare, lambda x, prep, a, b: dp(x, rhs, prep, a, b),
                  lhs, pens_cols, pens_rows, la, lb, slope, bias_eps)


def forward_plain(lhs, rhs, pens_cols, pens_rows, la, lb, slope=None,
                  bias_eps=None):
    """The plain version on any device (kernel comparisons on the card)."""
    return run_dp(prepare, lambda x, prep, a, b: plain(x, rhs, prep, a, b),
                  lhs, pens_cols, pens_rows, la, lb, slope, bias_eps)
