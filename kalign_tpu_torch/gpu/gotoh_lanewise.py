"""Problem-per-lane Gotoh forward for large merge batches.

Kernel: csrc/gotoh_lanewise.cu (replaces the TPU kernel
kalign_tpu/tpu/gotoh_lanewise.py::_kernel, gotoh_forward_lanewise:357).
The same DP as the row kernel, but the in-row gap state is the direct
recurrence GA[j] = max(GA[j-1] + ge[j], A[j-1] + go[j]), computed in
gotoh_forward_direct_np's float op order (which differs from the row
kernel's scan transform, so the two may resolve near-ties differently;
both are score-optimal).

Routing keeps the TPU engine's rule: a bucket takes this kernel when its
power-of-two launch batch is a multiple of BT = 1024 problems
(kalign_tpu/tpu/engine.py:264-273).  On the TPU that is the vector tile;
here it only keeps the two engines' routing, and so their near-tie
behaviour, alike.

Layouts: inputs as gotoh_row.forward (problem-major; the kernel sweeps
each problem with one warp, R rows per lane, see csrc/gotoh_lanewise.cu;
``launch_plan`` sizes its block).  Decisions come back in this package's
own layout, eight 4-bit cells per int32, problem-major with the rows
innermost: dec [B, L2p/8, L1p4] (L1p4 = L1p rounded up to ROW_QUANTUM),
cell (b, i, j) at word [b, j // 8, i], bits 4*(j % 8), so that a lane
stores its four rows' word of eight columns in one 16-byte store.  Walk
it with traceback.walk_lanewise.  Rows past a problem's length hold no
decisions of its (the kernel may write any value there).
"""

from collections import namedtuple

import torch

from kalign_tpu_torch.gpu import _cuda
from kalign_tpu_torch.gpu.gotoh_row import SMEM_LIMIT, pick_dp, run_dp
from kalign_tpu_torch.gpu.scan import prefix_sums_f32

NEG = -3.0e38
BT = 1024          # routing granularity (launch batches of k * 1024)
PACK = 8           # decision cells per int32 word
ROW_QUANTUM = 4    # decision rows are padded to a multiple of this
MAX_WARPS = 4      # problems (warps) per block

launches = 0

LanewiseLaunch = namedtuple("LanewiseLaunch", "warps smem")


def smem_bytes(L2p: int, nc: int, warps: int) -> int:
    """csrc/gotoh_lanewise.cu::kt_gotoh_lanewise_smem_bytes: per warp, a
    record of 4 + nc floats (padded to a float4) per column and the strip
    boundary row (3 floats per column); nc = 0 on the match-stream
    route."""
    return warps * L2p * (4 + -(-nc // 4) * 4 + 3) * 4


def launch_plan(L2p: int, nc: int = 0) -> LanewiseLaunch:
    """MAX_WARPS problems per block, fewer where their shared memory
    would not fit one block."""
    warps = min(MAX_WARPS, SMEM_LIMIT // smem_bytes(L2p, nc, 1))
    if warps < 1:
        raise ValueError(f"lanewise Gotoh kernel: L2p={L2p}, nc={nc} needs "
                         f"more shared memory than one block has")
    return LanewiseLaunch(warps, smem_bytes(L2p, nc, warps))


def dec_rows(L1p: int) -> int:
    """Rows of the decision array: L1p rounded up to ROW_QUANTUM."""
    return -(-L1p // ROW_QUANTUM) * ROW_QUANTUM


def launch_kernel(entry, name, args, B, L1p, L2p, nc, prep, la, lb):
    """Allocate the outputs and launch one instantiation of
    csrc/gotoh_lanewise.cu through its C entry point (named entry): args
    are the match source's leading arguments."""
    dev = la.device
    dec = torch.empty((B, L2p // PACK, dec_rows(L1p)), dtype=torch.int32,
                      device=dev)
    score = torch.empty(B, dtype=torch.float32, device=dev)
    state = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return dec, score, state
    plan = launch_plan(L2p, nc)
    lib = _cuda.lib()
    if lib.kt_gotoh_lanewise_smem_bytes(L2p, nc, plan.warps) != plan.smem:
        raise RuntimeError(f"{name}: shared-memory size differs between "
                           "csrc/gotoh_lanewise.cu and launch_plan")
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *args, *(prep[k].data_ptr() for k in (
                "colpen", "cols_eps", "rowpen", "row_term", "gb0", "ga0")),
            la.data_ptr(), lb.data_ptr(), B, L1p, L2p, plan.warps,
            dec.data_ptr(), score.data_ptr(), state.data_ptr(),
            _cuda.stream(dev))
    _cuda.check(rc, name)
    return dec, score, state


def prepare(pens_cols, pens_rows, la, lb, slope, bias_eps):
    """Penalty / boundary arrays shared by the kernel and its plain
    version (gotoh_lanewise.py::_prep_streams), all problem-major."""
    B = pens_cols.shape[0]
    L2p = pens_cols.shape[2] - 1
    L1p = pens_rows.shape[2] - 1
    dev = pens_cols.device
    f32 = dict(dtype=torch.float32, device=dev)
    slope_eps = slope * bias_eps
    cols_f = torch.arange(1, L2p + 1, device=dev).to(torch.float32)
    rows_f = torch.arange(1, L1p + 1, device=dev).to(torch.float32)
    cols = torch.arange(1, L2p + 1, device=dev)[None, :]
    C_term, cum_tgeA = prefix_sums_f32(pens_cols[:, 2, 1:],
                                       pens_rows[:, 2, 1:])   # cum: [B, L1p]
    ga0 = torch.where(cols <= lb[:, None], C_term, torch.full((), NEG, **f32))
    gb0 = torch.cat([torch.full((B, 1), NEG, **f32), cum_tgeA], dim=1)
    lb0_score = torch.cat([torch.zeros((B, 1), **f32), cum_tgeA],
                          dim=1).gather(1, la[:, None].long())[:, 0]
    return dict(
        colpen=pens_cols.contiguous(),                       # [B, 3, L2p+1]
        cols_eps=(cols_f[None, :] * bias_eps[:, None]).contiguous(),
        rowpen=pens_rows.contiguous(),                       # [B, 3, L1p+1]
        row_term=(rows_f[None, :] * slope_eps[:, None]).contiguous(),
        gb0=gb0.contiguous(),                                # [B, L1p+1]
        ga0=ga0.contiguous(),                                # [B, L2p]
        lb0_score=lb0_score)


def _to_int32_words(w):
    w = w & 0xFFFFFFFF
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def plain(match, prep, la, lb):
    """The kernel's arithmetic in PyTorch: vectors over the batch, a loop
    over cells (gotoh_forward_direct_np's op order)."""
    B, L1p, L2p = match.shape
    dev = match.device
    f32 = dict(dtype=torch.float32, device=dev)
    colpen = prep["colpen"].permute(1, 2, 0)                 # [3, L2p+1, B]
    rowpen = prep["rowpen"].permute(1, 2, 0)                 # [3, L1p+1, B]
    goB, geB, tgeB = colpen[0], colpen[1], colpen[2]
    cols_eps = prep["cols_eps"].t()                          # [L2p, B]
    row_term = prep["row_term"].t()                          # [L1p, B]
    gb0 = prep["gb0"].t()                                    # [L1p+1, B]
    SA = torch.full((L2p, B), NEG, **f32)
    SGA = prep["ga0"].t().clone()
    SGB = torch.full((L2p, B), NEG, **f32)
    words = torch.zeros((B, L2p // PACK, dec_rows(L1p)), dtype=torch.int64,
                        device=dev)
    negv = torch.full((B,), NEG, **f32)
    for i in range(1, L1p + 1):
        valid = la >= i
        last = la == i
        goA_i, geA_i, tgeA_i = rowpen[0, i], rowpen[1, i], rowpen[2, i]
        goA_prev = rowpen[0, i - 1]
        rterm = row_term[i - 1]
        A_pm1 = torch.full((B,), 0.0 if i == 1 else NEG, **f32)
        GA_pm1 = negv
        GB_pm1 = gb0[i - 1]
        A_cur = negv
        GA_cur = negv
        word = torch.zeros(B, dtype=torch.int64, device=dev)
        for j in range(1, L2p + 1):
            # copies: the state rows are overwritten in place below
            A_p, GA_p, GB_p = (SA[j - 1].clone(), SGA[j - 1].clone(),
                               SGB[j - 1].clone())
            m = match[:, i - 1, j - 1]
            m = m - torch.abs(cols_eps[j - 1] - rterm)
            diagA = A_pm1
            dGA = GA_pm1 + goB[j - 1]
            dGB = GB_pm1 + goA_prev
            best01 = torch.maximum(diagA, dGA)
            A_new = torch.maximum(best01, dGB) + m

            term = lb == j
            ge_eff = torch.where(term, tgeA_i, geA_i)
            go_eff = torch.where(term, tgeA_i, goA_i)
            gb_e = GB_p + ge_eff
            gb_o = A_p + go_eff
            GB_new = torch.maximum(gb_e, gb_o)

            ge_row = torch.where(last, tgeB[j], geB[j])
            go_row = torch.where(last, tgeB[j], goB[j])
            ga_e = GA_cur + ge_row
            ga_o = A_cur + go_row
            GA_new = torch.maximum(ga_e, ga_o)

            d = torch.where(dGB >= best01, 2, torch.where(dGA >= diagA, 1, 0))
            d = d | torch.where(ga_e > ga_o, 4, 0) | torch.where(gb_e > gb_o,
                                                                  8, 0)
            nib = (j - 1) % PACK
            word = word | (d << (4 * nib))
            if nib == PACK - 1:
                words[:, (j - 1) // PACK, i - 1] = word
                word = torch.zeros_like(word)

            A_n = torch.where(valid, A_new, A_p)
            GA_n = torch.where(valid, GA_new, GA_p)
            SA[j - 1] = A_n
            SGA[j - 1] = GA_n
            SGB[j - 1] = torch.where(valid, GB_new, GB_p)
            A_pm1, GA_pm1, GB_pm1 = A_p, GA_p, GB_p
            A_cur, GA_cur = A_n, GA_n

    idx = (lb.long() - 1).clamp(min=0, max=L2p - 1)[None, :]
    in_range = (lb >= 1) & (lb <= L2p)

    def pick(x):
        return torch.where(in_range, x.gather(0, idx)[0], negv)

    ea, ega, egb = pick(SA), pick(SGA), pick(SGB)
    score = torch.maximum(torch.maximum(ea, ega), egb)
    state = torch.where(ega > ea, torch.where(egb > ega, 2, 1),
                        torch.where(egb > ea, 2, 0)).to(torch.int32)
    return _to_int32_words(words), score, state


def launch(match, prep, la, lb):
    """Launch csrc/gotoh_lanewise.cu on CUDA tensors."""
    global launches
    match = match.contiguous()
    B, L1p, L2p = match.shape
    if L2p % PACK:
        raise ValueError(f"lanewise Gotoh kernel: L2p={L2p} is not a "
                         f"multiple of {PACK}")
    with torch.cuda.device(match.device):
        _cuda.require_cuda("gotoh_lanewise", match, prep["colpen"],
                           prep["cols_eps"], prep["rowpen"], prep["row_term"],
                           prep["gb0"], prep["ga0"], la, lb)
    out = launch_kernel("kt_gotoh_lanewise_forward", "gotoh_lanewise",
                        (match.data_ptr(),), B, L1p, L2p, 0, prep, la, lb)
    if B:
        launches += 1
    return out


def forward(match, pens_cols, pens_rows, la, lb, slope=None, bias_eps=None):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    return run_dp(prepare, pick_dp("gotoh_lanewise", match, launch, plain),
                  match, pens_cols, pens_rows, la, lb, slope, bias_eps)


def forward_plain(match, pens_cols, pens_rows, la, lb, slope=None,
                  bias_eps=None):
    """The plain version on any device (kernel comparisons on the card)."""
    return run_dp(prepare, plain, match, pens_cols, pens_rows, la, lb, slope,
                  bias_eps)


def pack_dec(cells):
    """[B, L1p, L2p] decision cells (4 bits each) -> the kernel's
    [B, L2p/8, L1p4] int32 nibble words, padding rows zero (tests and
    kernel checks)."""
    B, L1p, L2p = cells.shape
    d = (cells.to(torch.int64) & 0xF).reshape(B, L1p, L2p // PACK, PACK)
    w = sum(d[..., u] << (4 * u) for u in range(PACK)).permute(0, 2, 1)
    w = torch.nn.functional.pad(w, (0, dec_rows(L1p) - L1p))
    return _to_int32_words(w).contiguous()


def unpack_dec(dec_packed, L2p: int):
    """[B, L2p/8, L1p4] int32 nibbles -> [B, L1p4, L2p] uint8 (tests)."""
    B, W8, L1p4 = dec_packed.shape
    w = dec_packed.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros((B, L1p4, L2p), dtype=torch.uint8,
                      device=dec_packed.device)
    for u in range(PACK):
        nib = ((w >> (4 * u)) & 0xF).to(torch.uint8)       # [B, W8, L1p4]
        out[:, :, u::PACK] = nib.permute(0, 2, 1)
    return out
