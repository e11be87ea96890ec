"""Column-sharded Gotoh forward: one DP problem, its columns in bands over
the shards of a mesh.

Kernel: csrc/gotoh_mesh.cu (replaces kalign_tpu/parallel/mesh.py::
sharded_long_gotoh :288, a shard_map wavefront that passes a 4-float
halo per row by lax.ppermute).  The note at the top of the CUDA source
gives its design and what bounds it.

Shard d owns the columns [d * Wd, (d + 1) * Wd) of the padded width
Wp = n * Wd.  Rows go in blocks of ``BLOCK_ROWS``; at host step s, shard
d runs its block s - d on its own stream (``schedule``), reading the left
neighbour's strip of that block — [R + 1, STRIP] floats: A, GA and GB at
the neighbour's last column for the row above the block and each row of
it, the prefix max of u over every column up to there and u there (the
reference's packet of mesh.py:445-447 plus that u, from which the row
kernel decides the GA-extend bit at a band's first column) — and writing
its own for shard d + 1.  A strip for another card is copied there with
``copy_(non_blocking=True)`` on the producer's stream; the consumer's
stream waits on a CUDA event.  The host enqueues every step and
synchronises once, when the caller fetches.  ceil(la / R) launches per
shard, ceil(la / R) + n - 1 steps (rows past la are never read).

Every band takes the row kernel's row-invariant vectors
(gotoh_row.prepare over the whole padded width, prefix sums left to
right in float32 on the first shard's device) sliced to its columns, and
the row kernel's cell arithmetic, so the bands' decisions, score and end
state are the unsplit row kernel's bit for bit.

``schedule`` (and so ``forward``) launches the kernel (``launch``) on
CUDA shards and runs ``plain`` — the same block in PyTorch, row by row,
with the same strip handoff — on CPU shards; ``use_plain=True`` runs the
plain version on any device (the kernel's check on the card).
"""

import ctypes
from collections import namedtuple
from contextlib import contextmanager, nullcontext

import torch

from kalign_tpu_torch.gpu import _cuda
from kalign_tpu_torch.gpu.gotoh_row import NEG

BLOCK_ROWS = 256           # rows per launch: ceil(la / 256) launches a band
STRIP = 5                  # floats per strip row: A, GA, GB, carry, u
MAX_THREADS = 1024         # csrc/gotoh_mesh.cu kMaxThreads

launches = 0

# one shard of a mesh: its device and, on a card, its own stream
Shard = namedtuple("Shard", "device stream")


@contextmanager
def on(shard):
    """Work queued inside runs on the shard's device and stream."""
    if shard.stream is None:
        with nullcontext():
            yield
    else:
        with torch.cuda.device(shard.device), torch.cuda.stream(shard.stream):
            yield


def event(shard):
    """A CUDA event recorded on the shard's stream (None on the CPU)."""
    if shard.stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(shard.stream)
    return ev


def wait(shard, ev):
    if ev is not None:
        shard.stream.wait_event(ev)


def threads_for(Wd: int) -> int:
    """Block size of a band of Wd columns: as few tiles of at most
    MAX_THREADS columns as cover it, the block no wider than a tile."""
    tiles = -(-Wd // MAX_THREADS)
    return -(-Wd // (tiles * 32)) * 32


def band_width(W: int, n: int) -> int:
    """Columns of each of n bands over a row of W columns (W padded to a
    multiple of n, as mesh.py:516 pads it)."""
    return -(-W // n)


def band_inputs(prep, c0: int, c1: int, device):
    """The row-invariant vectors of one problem (gotoh_row.prepare of a
    batch of 1) cut to the columns [c0, c1), on device."""
    def put(x):
        return x.to(device).contiguous()
    return dict(colpen=put(prep["colpen"][:, 0, c0:c1]),
                cols_eps=put(prep["cols_eps"][0, c0:c1]),
                rowpen=put(prep["rowpen"][0]),
                row_term=put(prep["row_term"][0]),
                ga0=put(prep["ga0"][0, c0:c1]), c0=c0)


def init_state(band):
    """The band's state buffer [2, 3, Wd]: row 0 in slot 0 (A = NEG, GA =
    the terminal gap run of row 0, GB = NEG)."""
    ga0 = band["ga0"]
    state = torch.full((2, 3, ga0.shape[0]), NEG, dtype=torch.float32,
                       device=ga0.device)
    state[0, 1] = ga0
    return state


def plain(band, strip_in, strip_out, r0: int, nr: int, la: int,
                lb: int, first: bool):
    """Rows r0 + 1 .. r0 + nr of one band in PyTorch: the kernel's
    arithmetic (gotoh_row.plain's, with the strip at the band's left
    edge)."""
    match, state, dec = band["match"], band["state"], band["dec"]
    C_norm, C_term, gnC_norm, gnC_term, goB_s = band["colpen"]
    rowpen, cols_eps, row_term = band["rowpen"], band["cols_eps"], \
        band["row_term"]
    dev = match.device
    f32 = dict(dtype=torch.float32, device=dev)
    Wd = match.shape[1]
    cols = torch.arange(band["c0"] + 1, band["c0"] + Wd + 1, device=dev)
    is_term_col = cols == lb
    can_open = cols < lb
    neg = torch.full((1,), NEG, **f32)
    prev = state[r0 & 1]
    strip_out[0, :3] = prev[:, Wd - 1]
    strip_out[0, 3:] = NEG
    for s in range(1, nr + 1):
        row = r0 + s
        r = row - 1
        goA_i, geA_i, tgeA_i, goA_prev, gb0_prev = rowpen[r].split(1)
        A, GA, GB = state[(row - 1) & 1]
        if first:
            eA = torch.full((1,), 0.0 if row == 1 else NEG, **f32)
            eGA, eGB, carry, lu = neg, gb0_prev, neg, neg
        else:
            eA, eGA, eGB = strip_in[s - 1, 0:1], strip_in[s - 1, 1:2], \
                strip_in[s - 1, 2:3]
            carry, lu = strip_in[s, 3:4], strip_in[s, 4:5]
        m = match[r] - torch.abs(cols_eps - row_term[r:r + 1])
        diagA = torch.cat([eA, A[:-1]])
        diagGA = torch.cat([eGA, GA[:-1]]) + goB_s
        diagGB = torch.cat([eGB, GB[:-1]]) + goA_prev
        best01 = torch.maximum(diagA, diagGA)
        A_row = torch.maximum(best01, diagGB) + m

        ge_eff = torch.where(is_term_col, tgeA_i, geA_i)
        go_eff = torch.where(is_term_col, tgeA_i, goA_i)
        gb_e = GB + ge_eff
        gb_o = A + go_eff
        GB_row = torch.maximum(gb_e, gb_o)

        last = row == la
        C = C_term if last else C_norm
        gnC = gnC_term if last else gnC_norm
        u = torch.where(can_open, A_row + gnC, neg)
        cm = torch.maximum(torch.cummax(u, dim=0).values, carry)
        cm_s = torch.cat([carry, cm[:-1]])
        u_s = torch.cat([lu, u[:-1]])
        GA_row = cm_s + C

        d = torch.where(diagGB >= best01, 2,
                        torch.where(diagGA >= diagA, 1, 0))
        d = d | torch.where(cm_s > u_s, 4, 0) | torch.where(gb_e > gb_o, 8, 0)
        dec[r] = d.to(torch.int8)
        state[row & 1] = torch.stack([A_row, GA_row, GB_row])
        strip_out[s] = torch.stack([A_row[-1], GA_row[-1], GB_row[-1],
                                    cm[-1], u[-1]])


def launch(band, strip_in, strip_out, r0: int, nr: int, la: int,
                 lb: int, first: bool):
    """Launch csrc/gotoh_mesh.cu on one band's CUDA tensors."""
    global launches
    dev = band["match"].device
    Wd = band["match"].shape[1]
    keys = ("match", "colpen", "rowpen", "cols_eps", "row_term", "state",
            "dec")
    with torch.cuda.device(dev):
        _cuda.require_cuda("gotoh_mesh", *(band[k] for k in keys),
                           strip_out, *(() if first else (strip_in,)))
        if band["match"].dtype != torch.float32 or \
                band["dec"].dtype != torch.int8:
            raise ValueError("gotoh_mesh: float32 match, int8 decisions")
        rc = _cuda.lib().kt_gotoh_band_block(
            *(band[k].data_ptr() for k in keys[:6]),
            None if first else strip_in.data_ptr(), strip_out.data_ptr(),
            band["dec"].data_ptr(), Wd, r0, nr, la, lb, band["c0"],
            int(first), threads_for(Wd), ctypes.c_void_p(_cuda.stream(dev)))
    _cuda.check(rc, "gotoh_mesh")
    launches += 1


def schedule(shards, bands, la: int, lb: int, rows: int = BLOCK_ROWS,
             use_plain: bool = False):
    """The block-pipelined wavefront over the bands (bands[d] on
    shards[d], each with its state buffer and decision rows): at step s,
    shard d runs its block s - d.  Fills every band's dec rows < la and
    leaves row la's state in state[la & 1].  Kernel blocks on CUDA
    shards, plain on CPU shards or with use_plain."""
    n = len(shards)
    blocks = -(-la // rows)
    inbox = {}
    for s in range(blocks + n - 1):
        for d in range(n):
            b = s - d
            if not 0 <= b < blocks:
                continue
            sh, band = shards[d], bands[d]
            r0 = b * rows
            nr = min(rows, la - r0)
            with on(sh):
                strip_in = None
                if d:
                    strip_in, ev = inbox.pop((d, b))
                    wait(sh, ev)
                strip_out = torch.empty((rows + 1, STRIP),
                                        dtype=torch.float32,
                                        device=sh.device)
                use_kernel = sh.device.type == "cuda" and not use_plain
                (launch if use_kernel else plain)(
                    band, strip_in, strip_out, r0, nr, la, lb, d == 0)
                if d + 1 < n:
                    nxt = shards[d + 1]
                    dst = strip_out
                    if nxt.device != sh.device:
                        dst = torch.empty_like(strip_out, device=nxt.device)
                        dst.copy_(strip_out, non_blocking=True)
                    if nxt.stream is not None:
                        dst.record_stream(nxt.stream)
                    inbox[(d + 1, b)] = (dst, event(sh))


def end_values(state, la: int, lb: int, c0: int):
    """Score and end state at column lb of the band holding it, from row
    la's state (gotoh_row.plain's pick): tensors [1]."""
    A, GA, GB = state[la & 1][:, lb - 1 - c0:lb - c0]
    ea, ega, egb = (torch.clamp(x, min=NEG) for x in (A, GA, GB))
    score = torch.maximum(torch.maximum(ea, ega), egb)
    st = torch.where(ega > ea, torch.where(egb > ega, 2, 1),
                     torch.where(egb > ea, 2, 0)).to(torch.int32)
    return score, st


def forward(shards, match_bands, prep, la: int, lb: int,
            rows: int = BLOCK_ROWS, use_plain: bool = False):
    """One problem's column-sharded DP.  match_bands[d] [L1p, Wd] on
    shards[d] (the centering bias not yet subtracted where prep carries
    it, as for the row kernel); prep = gotoh_row.prepare of the problem
    over the padded width n * Wd, on shards[0]'s device, queued there.
    Returns (bands, score [1], state [1] int32 on shards[0]'s device);
    each band's decision rows < la are its dec (rows past la are 0)."""
    Wd = match_bands[0].shape[1]
    ready = event(shards[0])
    bands = []
    for d, sh in enumerate(shards):
        with on(sh):
            wait(sh, ready)
            band = band_inputs(prep, d * Wd, (d + 1) * Wd, sh.device)
            band["match"] = match_bands[d]
            band["state"] = init_state(band)
            band["dec"] = torch.zeros(match_bands[d].shape, dtype=torch.int8,
                                      device=sh.device)
            bands.append(band)
    if shards[0].stream is not None:
        for x in prep.values():
            for sh in shards[1:]:
                if sh.device == shards[0].device:
                    x.record_stream(sh.stream)
    schedule(shards, bands, la, lb, rows, use_plain)
    if lb == 0:
        with on(shards[0]):
            score = prep["lb0_score"].clone()
            st = torch.full((1,), 2, dtype=torch.int32,
                            device=shards[0].device)
        return bands, score, st
    o = (lb - 1) // Wd
    with on(shards[o]):
        score, st = end_values(bands[o]["state"], la, lb, o * Wd)
        done = event(shards[o])
    with on(shards[0]):
        wait(shards[0], done)
        if o and shards[0].stream is not None and \
                shards[o].device == shards[0].device:
            # read on the first shard's stream from here on
            score.record_stream(shards[0].stream)
            st.record_stream(shards[0].stream)
        return bands, score.to(shards[0].device), st.to(shards[0].device)


def gather_dec(shards, bands, width: int):
    """The bands' decisions side by side in one [1, L1p, width] int8
    tensor on shards[0]'s device (width >= n * Wd; the walk takes widths
    that are multiples of 16), queued on shards[0]'s stream."""
    L1p, Wd = bands[0]["dec"].shape
    with on(shards[0]):
        full = torch.zeros((1, L1p, width), dtype=torch.int8,
                           device=shards[0].device)
        ready = event(shards[0])
    done = []
    for d, sh in enumerate(shards):
        with on(sh):
            wait(sh, ready)
            full[0, :, d * Wd:(d + 1) * Wd].copy_(bands[d]["dec"],
                                                 non_blocking=True)
            done.append(event(sh))
    for ev in done:
        wait(shards[0], ev)
    return full
