"""The row Gotoh DP past 114,688 columns: one problem at a time, its rows
in blocks of one launch each, its columns in a wavefront of thread-block
clusters.

Kernel: csrc/gotoh_row_wave.cu (replaces kalign_tpu/tpu/gotoh_pallas.py
::gotoh_forward_pallas :272 past its plan's widths, where kalign_tpu runs
its XLA scan, tpu/gotoh.py:47 gotoh_forward; the design of
kalign_tpu/parallel/mesh.py:288 sharded_long_gotoh on one card).  The
note at the top of the CUDA source gives its design and what bounds it.
The plan (clusters, blocks, columns) is gotoh_row.wave_config's.

The match never exists whole: ``run`` asks a source for the prepared
match of each block of ``block_rows`` rows (the engine's source is the
fp32 product of those rows, with the bias and bonus added in place by
csrc/prepare_match.cu where a bonus is present: ``forward_operands``),
launches the wavefront on it, and carries every column's row state from
launch to launch in a state buffer.  Decisions go into one [B, L1p, L2p]
int8 tensor in the row kernel's layout (only rows < la written), so
traceback.walk_rows walks them unchanged; score and end state come from
the last launch's state.

``plain`` is the same schedule in PyTorch: per block of rows, each unit
of columns (by default the kernel's block width) computed over the block
from its own columns and the strip its left neighbour wrote, the state
carried between blocks.  Each cell's arithmetic is gotoh_row.plain's, so
kernel, plain version and the unsplit row DP agree bit for bit.
"""

import ctypes

import torch

from kalign_tpu_torch.gpu import _cuda, gotoh_row
from kalign_tpu_torch.gpu import prepare as P
from kalign_tpu_torch.gpu.gotoh_row import NEG

# the match of one block of rows: as many rows as keep it within
# BLOCK_BYTES (at 156,032 columns 3,441 rows, 2.1 GB), at least MIN_ROWS
BLOCK_BYTES = 2 << 30
MIN_ROWS = 512
# a band publishes its strip every EVERY rows (and at a launch's last)
EVERY = 8
STRIP = 8          # floats per strip row (csrc/gotoh_row_wave.cu kWaveStrip)

launches = 0


def block_rows(L1p: int, L2p: int) -> int:
    """Rows of a launch for a problem of L1p x L2p."""
    return max(1, min(L1p, max(MIN_ROWS, BLOCK_BYTES // (4 * L2p))))


def problem_bytes(L1p: int, L2p: int) -> int:
    """Device bytes one problem takes on this route: its decisions, the
    match of two blocks of rows (one made while the other runs), the
    state buffer and the strips."""
    L1p, L2p = int(L1p), int(L2p)
    cfg = gotoh_row.wave_config(L2p)
    Wp = cfg.bands * cfg.blocks * cfg.band
    R = block_rows(L1p, L2p)
    return (L1p * L2p + 2 * 4 * R * L2p + 4 * 6 * Wp
            + 4 * cfg.bands * (R * STRIP + 1))


_max_active = {}


def max_active(cfg) -> int:
    """cudaOccupancyMaxActiveClusters of the plan (cached per device and
    plan)."""
    key = (torch.cuda.current_device(), cfg.threads, cfg.ch, cfg.blocks,
           cfg.smem)
    if key not in _max_active:
        out = ctypes.c_int(0)
        _cuda.check(_cuda.lib().kt_gotoh_row_wave_max_active(
            cfg.threads, cfg.ch, cfg.blocks, ctypes.c_size_t(cfg.smem),
            ctypes.byref(out)), "gotoh_row wave occupancy")
        _max_active[key] = out.value
    return _max_active[key]


def schedulable(L2p: int, cfg=None):
    """The plan of a width whose every cluster the card holds at once:
    wave_config's, or, where the card holds fewer clusters than it has
    bands, the plan over as many bands as it holds.  Raises where none
    fits: a band waits on the band to its left, so a cluster that is not
    resident could hold up the ones that are."""
    cfg = cfg or gotoh_row.wave_config(L2p)
    for _ in range(4):
        held = max_active(cfg)
        if held >= cfg.bands:
            return cfg
        if held < 1:
            break
        cfg = gotoh_row.wave_config(L2p, bands=held)
    raise RuntimeError(f"row Gotoh wave: the card cannot hold the "
                       f"{cfg.bands} clusters of {cfg.blocks} blocks of "
                       f"{cfg.threads} threads that {L2p} columns need")


def end_values(state, lb):
    """Score and end state of a problem from its last row's state [3, W]
    (gotoh_row.plain's pick at column lb, lb a [1] int tensor on the
    state's device): tensors [1]."""
    W = state.shape[1]
    neg = torch.full((1,), NEG, dtype=torch.float32, device=state.device)
    idx = (lb.long() - 1).clamp(min=0, max=W - 1)
    in_range = (lb >= 1) & (lb <= W)
    ea, ega, egb = (torch.where(in_range, torch.maximum(x.gather(0, idx),
                                                        neg), neg)
                    for x in state)
    score = torch.maximum(torch.maximum(ea, ega), egb)
    st = torch.where(ega > ea, torch.where(egb > ega, 2, 1),
                     torch.where(egb > ea, 2, 0)).to(torch.int32)
    return score, st


class Buffers:
    """One problem's buffers on the card for a plan: the state [2, 3, Wp]
    (row 0 in slot 0: A = GB = NEG, GA = the problem's terminal gap run
    ga0, NEG past L2p), the strips [bands, R, STRIP] and the bands'
    counters (zero)."""

    def __init__(self, prep, b: int, cfg, R: int):
        dev = prep["cols_eps"].device
        self.Wp = cfg.bands * cfg.blocks * cfg.band
        self.R = R
        ga0 = prep["ga0"][b]
        self.state = torch.full((2, 3, self.Wp), NEG, dtype=torch.float32,
                                device=dev)
        self.state[0, 1, :ga0.shape[0]] = ga0
        self.strip = torch.empty((cfg.bands, R, STRIP), dtype=torch.float32,
                                 device=dev)
        self.ready = torch.zeros(cfg.bands, dtype=torch.int32, device=dev)


def checked_plan(L2p: int, cfg=None):
    """schedulable's plan, its shared memory checked against the
    kernel's (call under torch.cuda.device of the inputs)."""
    cfg = schedulable(L2p, cfg)
    if _cuda.lib().kt_gotoh_row_wave_smem_bytes(cfg.threads, cfg.ch) != \
            gotoh_row.wave_smem_bytes(cfg.threads, cfg.ch):
        raise RuntimeError("row Gotoh wave: shared-memory size differs "
                           "between csrc/gotoh_row_wave.cu and wave_config")
    return cfg


def launch_block(m, prep, b: int, buf, dec_b, r0: int, k: int, la, lb,
                 cfg):
    """One launch: rows r0 .. r0 + len(m) - 1 of problem b (its k-th block
    of rows; those below la[b], which the kernel reads), m [nr, L2p] their
    prepared match on the card, the state read from buf.state[k & 1] and
    left in buf.state[(k + 1) & 1], decisions into dec_b [L1p, L2p]; la /
    lb the batch's [B] int32 lengths on the card.  Call under
    torch.cuda.device of the inputs."""
    global launches
    B, L1p, _ = prep["rowpen"].shape
    L2p = prep["cols_eps"].shape[1]
    nr = m.shape[0]
    _cuda.require_cuda("gotoh_row wave", m, prep["colpen"], prep["rowpen"],
                       prep["cols_eps"], prep["row_term"], buf.state, dec_b,
                       la, lb)
    if la.dtype != torch.int32 or lb.dtype != torch.int32:
        raise ValueError("gotoh_row wave: int32 lengths")
    if tuple(m.shape) != (nr, L2p) or m.dtype != torch.float32 or \
            nr > buf.R:
        raise ValueError("gotoh_row wave: a block's match is not [rows, L2p] "
                         "float32 within the strips' rows")
    rc = _cuda.lib().kt_gotoh_row_wave(
        m.data_ptr(), prep["colpen"].data_ptr(), prep["rowpen"].data_ptr(),
        prep["cols_eps"].data_ptr(), prep["row_term"].data_ptr(),
        buf.state.data_ptr(), buf.strip.data_ptr(), buf.ready.data_ptr(),
        dec_b.data_ptr(), la.data_ptr(), lb.data_ptr(), b, B, L1p, L2p,
        buf.Wp, r0, nr, buf.R, k & 1, EVERY, cfg.threads, cfg.ch,
        cfg.blocks, cfg.bands,
        ctypes.c_size_t(cfg.smem), _cuda.stream(m.device))
    _cuda.check(rc, "gotoh_row wave")
    launches += 1


def launch(source, prep, la, lb, cfg=None, rows=None, la_h=None,
           events=None):
    """The kernel on CUDA inputs: every problem's blocks of rows, each
    block's match from source(b, r0, r1, out) ([r1 - r0, L2p] contiguous
    float32 on the card; it may make it in out, a buffer of that shape).
    The next block's match is made on a second stream while the kernel
    runs the current one, in the other of two buffers (the wave leaves
    some of the card's SMs free).  With the host lengths
    la_h the launches stop at each problem's la; without them they cover
    L1p rows (the kernel stops at la; no transfer).  events: a list that
    gets a pair of CUDA events around each launch (the kernel's own
    device time).  Returns (dec [B, L1p, L2p], score [B], state [B])."""
    B, L1p, _ = prep["rowpen"].shape
    L2p = prep["cols_eps"].shape[1]
    dev = prep["cols_eps"].device
    la, lb = la.to(torch.int32).contiguous(), lb.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        cfg = checked_plan(L2p, cfg)
        R = rows or block_rows(L1p, L2p)
        dec = torch.empty((B, L1p, L2p), dtype=torch.int8, device=dev)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        # the source's inputs were queued on this stream
        side.wait_stream(main)
        blocks = [torch.empty((R, L2p), dtype=torch.float32, device=dev)
                  for _ in range(2)]
        read = [None, None]   # each buffer's last launch, an event

        def make(b, r0, r1, i):
            """The block's match in buffer i, made on the side stream once
            the launch that last read the buffer is done, and an event on
            it."""
            with torch.cuda.stream(side):
                if read[i] is not None:
                    side.wait_event(read[i])
                m = source(b, r0, r1, blocks[i][:r1 - r0])
                done = torch.cuda.Event()
                done.record(side)
            return m, done
        scores, states = [], []
        for b in range(B):
            buf = Buffers(prep, b, cfg, R)
            n = L1p if la_h is None else min(int(la_h[b]), L1p)
            starts = list(range(0, n, R))
            nxt = make(b, 0, min(R, n), 0) if starts else None
            for k, r0 in enumerate(starts):
                m, done = nxt
                main.wait_event(done)
                if events is not None:
                    events.append([torch.cuda.Event(enable_timing=True)
                                   for _ in range(2)])
                    events[-1][0].record()
                launch_block(m, prep, b, buf, dec[b], r0, k, la, lb, cfg)
                if events is not None:
                    events[-1][1].record()
                read[k % 2] = torch.cuda.Event()
                read[k % 2].record(main)
                if k + 1 < len(starts):
                    r1 = min(starts[k + 1] + R, n)
                    nxt = make(b, starts[k + 1], r1, (k + 1) % 2)
            k = len(starts)
            s, st = end_values(buf.state[k & 1][:, :L2p], lb[b:b + 1])
            scores.append(s)
            states.append(st)
        return dec, torch.cat(scores), torch.cat(states)


def plain_block(mblk, prep, b: int, prev, r0: int, la: int, lb: int,
                unit: int):
    """One block of rows of problem b in PyTorch: rows r0 .. r0 +
    len(mblk) - 1 from the state prev [3, W] of row r0, the units of
    ``unit`` columns left to right, each over the block's rows from its
    own columns and the strip of its left unit (A, GA, GB at its last
    column, the prefix max of u up to it, its last u).  Returns (the
    block's decisions [nr, W] int8, the state of its last row [3, W])."""
    W = prev.shape[1]
    nr = mblk.shape[0]
    dev = prev.device
    f32 = dict(dtype=torch.float32, device=dev)
    negc = torch.full((1,), NEG, **f32)
    cols = torch.arange(1, W + 1, device=dev)
    C_norm, C_term, gnC_norm, gnC_term, goB_s = prep["colpen"][:, b]
    ceps, rt = prep["cols_eps"][b], prep["row_term"][b]
    rp = prep["rowpen"][b]
    dec = torch.zeros((nr, W), dtype=torch.int8, device=dev)
    cur = prev.clone()
    strip = None
    for k, lo in enumerate(range(0, W, unit)):
        hi = min(lo + unit, W)
        A, GA, GB = (x[lo:hi] for x in prev)
        c = cols[lo:hi]
        is_term, can_open = c == lb, c < lb
        out = torch.empty((nr, 5), **f32)
        for q in range(nr):
            r = r0 + q
            row = r + 1
            goA_i, geA_i, tgeA_i, goA_prev, gb0_prev = rp[r].split(1)
            if k == 0:
                eA = torch.full((1,), 0.0 if row == 1 else NEG, **f32)
                eGA, eGB = negc, gb0_prev
            elif q == 0:
                eA, eGA, eGB = (x[lo - 1:lo] for x in prev)
            else:
                eA, eGA, eGB = (strip[q - 1, i:i + 1] for i in range(3))
            m = mblk[q, lo:hi] - torch.abs(ceps[lo:hi] - rt[r:r + 1])
            diagA = torch.cat([eA, A[:-1]])
            diagGA = torch.cat([eGA, GA[:-1]]) + goB_s[lo:hi]
            diagGB = torch.cat([eGB, GB[:-1]]) + goA_prev
            best01 = torch.maximum(diagA, diagGA)
            A_row = torch.maximum(best01, diagGB) + m
            ge_eff = torch.where(is_term, tgeA_i, geA_i)
            go_eff = torch.where(is_term, tgeA_i, goA_i)
            gb_e = GB + ge_eff
            gb_o = A + go_eff
            GB_row = torch.maximum(gb_e, gb_o)
            last = row == la
            C = (C_term if last else C_norm)[lo:hi]
            gnC = (gnC_term if last else gnC_norm)[lo:hi]
            u = torch.where(can_open, A_row + gnC, negc)
            cm = torch.cummax(u, dim=0).values
            if k == 0:
                cm_s = torch.cat([negc, cm[:-1]])
                u_s = torch.cat([negc, u[:-1]])
                carry = cm[-1:]
            else:
                cin, lu = strip[q, 3:4], strip[q, 4:5]
                cm_s = torch.cat([cin, torch.maximum(cin, cm[:-1])])
                u_s = torch.cat([lu, u[:-1]])
                carry = torch.maximum(cin, cm[-1:])
            GA_row = cm_s + C
            d = torch.where(diagGB >= best01, 2,
                            torch.where(diagGA >= diagA, 1, 0))
            d = d | torch.where(cm_s > u_s, 4, 0) | \
                torch.where(gb_e > gb_o, 8, 0)
            dec[q, lo:hi] = d.to(torch.int8)
            A, GA, GB = A_row, GA_row, GB_row
            out[q] = torch.cat([A[-1:], GA[-1:], GB[-1:], carry, u[-1:]])
        cur[:, lo:hi] = torch.stack([A, GA, GB])
        strip = out
    return dec, cur


def plain_state(prep, b: int):
    """Row 0's state [3, W] of problem b: A = GB = NEG, GA = ga0."""
    ga0 = prep["ga0"][b]
    neg = torch.full_like(ga0, NEG)
    return torch.stack([neg, ga0, neg])


def plain(source, prep, la, lb, cfg=None, rows=None, la_h=None, unit=None):
    """The schedule in PyTorch on any device: per block of rows
    (plain_block), the units of ``unit`` columns (default the plan's
    block width) left to right; the state carried from block to block."""
    B, L1p, _ = prep["rowpen"].shape
    W = prep["cols_eps"].shape[1]
    la_h = [int(x) for x in (la.tolist() if la_h is None else la_h)]
    cfg = cfg or gotoh_row.wave_config(W)
    R = rows or block_rows(L1p, W)
    unit = unit or cfg.band
    dec = torch.zeros((B, L1p, W), dtype=torch.int8,
                      device=prep["cols_eps"].device)
    scores, states = [], []
    for b in range(B):
        prev = plain_state(prep, b)
        n = min(la_h[b], L1p)
        lb_b = int(lb[b])
        for r0 in range(0, n, R):
            mblk = source(b, r0, min(r0 + R, n))
            dec[b, r0:r0 + mblk.shape[0]], prev = plain_block(
                mblk, prep, b, prev, r0, la_h[b], lb_b, unit)
        s, st = end_values(prev, lb[b:b + 1])
        scores.append(s)
        states.append(st)
    return dec, torch.cat(scores), torch.cat(states)


def run(source, prep, la, lb, la_h=None):
    """The kernel for CUDA inputs, the plain version for CPU ones."""
    if prep["cols_eps"].is_cuda:
        return launch(source, prep, la, lb, la_h=la_h)
    return plain(source, prep, la, lb, la_h=la_h)


def operand_source(lhs, rhs, la, lb, eps, bonus=None):
    """source(b, r0, r1, out=None): the match of rows [r0, r1) of problem
    b (in out where given), the fp32 product of those rows, with the bias
    and the bonus added in place at the block's rows where there is a
    bonus (prepare.prepare_match)."""
    rhs_t = rhs.transpose(1, 2)

    def source(b, r0, r1, out=None):
        m = torch.bmm(lhs[b:b + 1, r0:r1], rhs_t[b:b + 1],
                      out=None if out is None else out.unsqueeze(0))
        if bonus is not None:
            per_w, *vecs = bonus
            mine = (per_w,) + tuple(v[b:b + 1] for v in vecs)
            m = P.prepare_match(m, la[b:b + 1], lb[b:b + 1], eps[b:b + 1],
                                P.cut(mine, r0, r1), row0=r0)
        return m[0]
    return source


def forward_operands(lhs, rhs, pc, pr, la, lb, eps, bonus=None, la_h=None):
    """One launch batch through the wave from its operands (lhs [B, L1p,
    nc], rhs [B, L2p, nc]): each block's match is the fp32 product of its
    rows; with a bonus the bias and the bonus are added to it in place
    (prepare.prepare_match at the block's rows) and the DP adds no bias,
    without one the DP subtracts the bias (as gpu/engine.py::bucket_match
    and the row kernel share it).  Returns (dec, score, state) after the
    lb == 0 fix-up."""
    slope = lb.to(torch.float32) / torch.clamp(la.to(torch.float32), min=1.0)
    bias_eps = eps
    if bonus is not None:
        slope, bias_eps = torch.zeros_like(slope), torch.zeros_like(eps)
    prep = gotoh_row.prepare(pc, pr, la, lb, slope, bias_eps)
    dec, score, st = run(operand_source(lhs, rhs, la, lb, eps, bonus), prep,
                         la, lb, la_h)
    score, st = gotoh_row.fix_lb0(score, st, prep, lb)
    return dec, score, st
