"""Batched Myers bit-parallel edit distance (anchor distances).

Kernel: csrc/bpm.cu (replaces the TPU kernel
kalign_tpu/tpu/bpm_pallas.py::_kernel, bpm_batch_pallas:213).  The
function is the reference's blocked 64-bit kernel (lib/src/bpm.c:356-580):
patterns of up to MAX_PATTERN symbols, text padded with W = 64*b_max - m
symbols of code 0, the adaptive active-block window, and the minimum
score along the bottom row.

A batch is P (text, pattern) pairs over a device-resident token table
tok [N, L] uint8 (L a multiple of 16 on the card): text_idx [P] and
pat_idx [P] (the rows of tok holding the text and the pattern), n [P]
(text length, <= L), m [P] (pattern length) and the match-mask table
peq_seq [N, SIGMA, nblk] int64 of every row, from ``build_table`` with
the same lengths (m[p] == m_seq[pat_idx[p]]).  ``bpm_batch`` launches
the kernel for CUDA tensors and runs ``plain`` — kalign_tpu/tpu/bpm.py::
bpm_batch in PyTorch, every block computed and the window applied by
masks, on native 64-bit words, over the per-pair masks peq_seq[pat_idx]
— for CPU tensors.  ``build_table`` likewise launches csrc/bpm.cu's
table kernel or runs ``build_peq`` over the rows.
"""

from collections import namedtuple

import torch
import torch.nn.functional as F

from kalign_tpu_torch.gpu import _cuda

SIGMA = 13
WORD = 64
MAX_PATTERN = 1024
NBLK = MAX_PATTERN // WORD  # 16
# pairs per block of the distance kernel (csrc/bpm.cu::kThreads); it
# uses no shared memory
THREADS = 256

launches = 0          # distance kernel
table_launches = 0    # match-mask table kernel

BpmLaunch = namedtuple("BpmLaunch", "nblk threads smem")


def launch_plan(nblk: int) -> BpmLaunch:
    """csrc/bpm.cu's launch: the instantiation for nblk blocks of 64
    pattern symbols, THREADS pairs per block, no shared memory."""
    if not 1 <= nblk <= NBLK:
        raise ValueError(f"bpm: nblk={nblk} has no instantiation "
                         f"(1..{NBLK})")
    return BpmLaunch(nblk, THREADS, 0)


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


def plain_table(tok, m_seq, nblk: int):
    """The match masks of every row of tok [N, L] (``build_peq`` of the
    rows cut or zero-padded to nblk*64 symbols), lengths m_seq [N]."""
    width = nblk * WORD
    rows = tok[:, :width]
    if rows.shape[1] < width:
        rows = F.pad(rows, (0, width - rows.shape[1]))
    return build_peq(rows, m_seq, nblk)


def launch_table(tok, m_seq, nblk: int):
    """Launch csrc/bpm.cu's table kernel on CUDA tensors."""
    launch_plan(nblk)
    with torch.cuda.device(tok.device):
        return _launch_table(tok, m_seq, nblk)


def _launch_table(tok, m_seq, nblk: int):
    global table_launches
    _cuda.require_cuda("bpm table", tok, m_seq)
    if tok.dtype != torch.uint8 or m_seq.dtype != torch.int32:
        raise ValueError("bpm table: takes uint8 tokens, int32 lengths")
    N, L = tok.shape
    if L % 16 or tok.data_ptr() % 16:
        raise ValueError("bpm table: token rows must be 16-byte aligned "
                         f"(width {L})")
    table = torch.empty((N, SIGMA, nblk), dtype=torch.int64,
                        device=tok.device)
    if N == 0:
        return table
    rc = _cuda.lib().kt_bpm_table(tok.data_ptr(), L, m_seq.data_ptr(), N,
                                  nblk, table.data_ptr(),
                                  _cuda.stream(tok.device))
    _cuda.check(rc, "bpm table")
    table_launches += 1
    return table


def build_table(tok, m_seq, nblk: int):
    """Kernel on CUDA tensors, plain version on CPU tensors:
    [N, SIGMA, nblk] int64."""
    if tok.is_cuda:
        return launch_table(tok.contiguous(), m_seq.to(torch.int32)
                            .contiguous(), nblk)
    if tok.device.type == "cpu":
        return plain_table(tok, m_seq, nblk)
    raise ValueError(f"bpm table: unsupported device {tok.device}")


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


def plain(tok, text_idx, pat_idx, n, m, peq_seq, count_work: bool = False):
    """kalign_tpu/tpu/bpm.py::bpm_batch in PyTorch (masked window) over
    the per-pair masks peq_seq[pat_idx].  count_work=True also returns
    the number of (pair, text symbol, live block) steps the data needs,
    the work a bound is counted on."""
    dev = tok.device
    peq = peq_seq[pat_idx.long()]                             # [P, 13, nblk]
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


def launch(tok, text_idx, pat_idx, n, m, peq_seq):
    """Launch csrc/bpm.cu on CUDA tensors."""
    plan = launch_plan(peq_seq.shape[2])
    with torch.cuda.device(tok.device):
        return _launch(plan, tok, text_idx, pat_idx, n, m, peq_seq)


def _launch(plan, tok, text_idx, pat_idx, n, m, peq_seq):
    global launches
    P = text_idx.shape[0]
    _cuda.require_cuda("bpm", tok, text_idx, pat_idx, n, m, peq_seq)
    if (tok.dtype != torch.uint8 or peq_seq.dtype != torch.int64
            or peq_seq.shape[1] != SIGMA
            or any(x.dtype != torch.int32 for x in (text_idx, pat_idx, n, m))):
        raise ValueError("bpm: takes uint8 tokens, int64 masks [N, 13, nblk] "
                         "and int32 index vectors")
    if tok.shape[1] % 16 or tok.data_ptr() % 16:
        raise ValueError("bpm: token rows must be 16-byte aligned "
                         f"(width {tok.shape[1]})")
    out = torch.empty(P, dtype=torch.int32, device=tok.device)
    if P == 0:
        return out
    rc = _cuda.lib().kt_bpm_batch(
        tok.data_ptr(), tok.shape[1], text_idx.data_ptr(), pat_idx.data_ptr(),
        n.data_ptr(), m.data_ptr(), peq_seq.data_ptr(), P, plan.nblk,
        out.data_ptr(), _cuda.stream(tok.device))
    _cuda.check(rc, "bpm")
    launches += 1
    return out


def bpm_batch(tok, text_idx, pat_idx, n, m, peq_seq):
    """Kernel on CUDA tensors, plain version on CPU tensors.  [P] int32."""
    if tok.is_cuda:
        i32 = lambda x: x.to(torch.int32).contiguous()
        return launch(tok.contiguous(), i32(text_idx),
                      i32(pat_idx), i32(n), i32(m), peq_seq.contiguous())
    if tok.device.type == "cpu":
        return plain(tok, text_idx, pat_idx, n, m, peq_seq)
    raise ValueError(f"bpm: unsupported device {tok.device}")
