"""Batched Myers bit-parallel edit distance (anchor distances).

Kernel: csrc/bpm.cu (replaces the TPU kernel
kalign_tpu/tpu/bpm_pallas.py::_kernel, bpm_batch_pallas:213).  The
function is the reference's blocked 64-bit kernel (lib/src/bpm.c:356-580):
patterns of up to MAX_PATTERN symbols, text padded with W = 64*b_max - m
symbols of code 0, the adaptive active-block window, and the minimum
score along the bottom row.

A batch is P (text, pattern) pairs over a device-resident token table:
tok [N, Lmax] uint8, text_idx [P] (row of tok holding the text), n [P]
(text length), peq [P, SIGMA, nblk] int64 (the pattern's match masks from
``build_peq``) and m [P] (pattern length, <= nblk * 64).
``bpm_batch`` launches the kernel for CUDA tensors and runs ``plain`` —
kalign_tpu/tpu/bpm.py::bpm_batch in PyTorch, every block computed and
the window applied by masks, on native 64-bit words — for CPU tensors.
"""

import torch

from kalign_tpu_torch.gpu import _cuda

SIGMA = 13
WORD = 64
MAX_PATTERN = 1024
NBLK = MAX_PATTERN // WORD  # 16

launches = 0


def build_peq(patterns, m, nblk: int):
    """patterns [P, nblk*64] uint8 codes (content beyond m ignored), m [P]
    -> Peq [P, SIGMA, nblk] int64 where positions >= m match every symbol
    (bpm.c:428-440; bit k of block b is pattern position 64*b + k)."""
    P = patterns.shape[0]
    dev = patterns.device
    pos = torch.arange(nblk * WORD, device=dev)
    beyond = pos[None, :] >= m[:, None].to(torch.int64)       # [P, L]
    sym = torch.arange(SIGMA, dtype=torch.uint8, device=dev)
    hit = (patterns[:, None, :] == sym[None, :, None]) | beyond[:, None, :]
    hit = hit.view(P, SIGMA, nblk, WORD)
    peq = torch.zeros((P, SIGMA, nblk), dtype=torch.int64, device=dev)
    for k in range(WORD):
        peq |= hit[..., k].to(torch.int64) << k
    return peq


def _advance(eq, pv, mv, h_in):
    """One 64-bit Myers block step; h_in in {-1, 0, 1}."""
    xv = eq | mv
    eq = torch.where(h_in < 0, eq | 1, eq)
    xh = (((eq & pv) + pv) ^ pv) | eq
    ph = mv | ~(xh | pv)
    mh = pv & xh
    h_out = (ph < 0).to(torch.int32) - (mh < 0).to(torch.int32)
    ph = ph << 1
    mh = mh << 1
    mh = torch.where(h_in < 0, mh | 1, mh)
    ph = torch.where(h_in > 0, ph | 1, ph)
    return mh | ~(xv | ph), ph & xv, h_out


def plain(tok, text_idx, n, peq, m, count_work: bool = False):
    """kalign_tpu/tpu/bpm.py::bpm_batch in PyTorch (masked window).
    count_work=True also returns the number of (pair, text symbol,
    live block) steps the data needs, the work a bound is counted on."""
    dev = tok.device
    P, _, nblk = peq.shape
    texts = tok[text_idx.long()]                              # [P, T]
    T = texts.shape[1]
    m = torch.clamp(m.to(torch.int32), max=nblk * WORD)
    n = n.to(torch.int32)
    b_max = torch.clamp((m + WORD - 1) // WORD, min=1)
    W = WORD * b_max - m
    maxd = m
    steps_needed = n + W
    blk = torch.arange(nblk, device=dev, dtype=torch.int32)[:, None]
    pidx = torch.arange(P, device=dev)

    y = b_max - 1
    act0 = blk <= y[None, :]
    Pv = torch.where(act0, -1, 0).to(torch.int64)            # [nblk, P]
    Mv = torch.zeros((nblk, P), dtype=torch.int64, device=dev)
    score = torch.where(act0, (blk + 1) * WORD, 0).to(torch.int32)
    k = maxd.clone()

    def gather_blk(arr, idx):
        return arr.gather(0, idx.long()[None, :])[0]

    total = int(steps_needed.max()) if P else 0
    work = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(total):
        valid = i < steps_needed
        if count_work:
            work += torch.where(valid, y + 1, 0).sum()
        c = torch.where(i < n, texts[:, min(i, T - 1)].to(torch.int64), 0)
        eq = peq[pidx, c].t()                                 # [nblk, P]
        h = torch.zeros(P, dtype=torch.int32, device=dev)
        for b in range(nblk):
            active = (b <= y) & valid
            pl, ml, h_out = _advance(eq[b], Pv[b], Mv[b], h)
            Pv[b] = torch.where(active, pl, Pv[b])
            Mv[b] = torch.where(active, ml, Mv[b])
            score[b] = torch.where(active, score[b] + h_out, score[b])
            h = torch.where(active, h_out, h)
        carry = h

        # adaptive window (bpm.c:510-567)
        sc_y = gather_blk(score, y)
        yb = torch.clamp(y + 1, max=nblk - 1)
        eq_next = gather_blk(eq, yb)
        grow = valid & (sc_y - carry <= maxd) & (y < b_max - 1) & \
            (((eq_next & 1) != 0) | (carry < 0))
        gpl, gml, g_hout = _advance(
            eq_next, torch.full_like(eq_next, -1), torch.zeros_like(eq_next),
            carry)
        gmask = (blk == yb[None, :]) & grow[None, :]
        Pv = torch.where(gmask, gpl[None, :], Pv)
        Mv = torch.where(gmask, gml[None, :], Mv)
        score = torch.where(gmask, (sc_y + WORD - carry + g_hout)[None, :],
                            score)
        y_after = torch.where(grow, yb, y)
        for _ in range(nblk):
            sc = gather_blk(score, y_after)
            down = (~grow) & valid & (sc >= maxd + WORD) & (y_after > 0)
            y_after = torch.where(down, y_after - 1, y_after)
        sc_final = gather_blk(score, y_after)
        k = torch.where(valid & (sc_final < k), sc_final, k)
        y = y_after
    if count_work:
        return k.to(torch.int32), int(work)
    return k.to(torch.int32)


def launch(tok, text_idx, n, peq, m):
    """Launch csrc/bpm.cu on CUDA tensors."""
    global launches
    P, _, nblk = peq.shape
    if not 1 <= nblk <= NBLK:
        raise ValueError(f"bpm: nblk={nblk} outside 1..{NBLK}")
    _cuda.require_cuda("bpm", tok, text_idx, n, peq, m)
    out = torch.empty(P, dtype=torch.int32, device=tok.device)
    if P == 0:
        return out
    rc = _cuda.lib().kt_bpm_batch(
        tok.data_ptr(), tok.shape[1], text_idx.data_ptr(), n.data_ptr(),
        peq.data_ptr(), m.data_ptr(), P, nblk, out.data_ptr(),
        _cuda.stream())
    _cuda.check(rc, "bpm")
    launches += 1
    return out


def bpm_batch(tok, text_idx, n, peq, m):
    """Kernel on CUDA tensors, plain version on CPU tensors.  [P] int32."""
    if tok.is_cuda:
        return launch(tok.contiguous(), text_idx.to(torch.int32).contiguous(),
                      n.to(torch.int32).contiguous(), peq.contiguous(),
                      m.to(torch.int32).contiguous())
    if tok.device.type == "cpu":
        return plain(tok, text_idx, n, peq, m)
    raise ValueError(f"bpm: unsupported device {tok.device}")
