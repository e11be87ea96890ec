"""Column-sharded Gotoh forward: one DP problem, its columns in bands over
the shards of a mesh.

Kernels: csrc/gotoh_mesh.cu (replaces kalign_tpu/parallel/mesh.py::
sharded_long_gotoh :288, a shard_map wavefront that passes a 4-float
halo per row by lax.ppermute).  The note at the top of the CUDA source
gives their design and what bounds them.  A band's width alone picks the
route (``band_config``): up to gotoh_row.CLUSTER_MAX_WIDTH (114,688)
columns one thread-block cluster per band of up to 16 blocks of
BLOCK_COLS (256) columns or more, one block up to 256
(``gotoh_band_cluster_kernel``, the row kernel's register body in the
cluster row kernel's form); past that a wavefront of WAVE_BANDS clusters
of gotoh_row.WAVE_CLUSTER blocks over the band (``gotoh_band_wave_kernel``,
the row kernel's wave route, gpu/gotoh_wave.py, with the mesh's strips at
the band's two ends), planned so that every cluster of the band launches
that can run at once on a card is resident (``card_streams``).  A band
that has its card to itself (``alone``: one shard a card) takes the wave
route from ALONE_WAVE_MIN columns on: one cluster of 16 blocks would
leave most of the card's SMs idle and make each of its blocks' rows
long.

Shard d owns the columns [d * Wd, (d + 1) * Wd) of the padded width
Wp = n * Wd, Wd = ``band_width`` (ceil(W / n) rounded up to
gotoh_row.COL_QUANTUM and to the columns the route's blocks cover).
Rows go in blocks of ``BLOCK_ROWS``; at host step s, shard d runs its
block s - d on its own stream (``schedule``), reading the left
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

A band's match comes a block of rows at a time from its source
(``forward``): a whole band's tensor, whose rows each launch reads in
place, or a callable source(r0, r1, out) that makes the match of the
rows [r0, r1) in ``out``, a buffer of a ring of two on the band's shard
(parallel/mesh.py::band_source: the rows' product and prepare_match).
A buffer holds fill_rows' rows (FILL_BLOCKS launches' rows, or one
launch's past BLOCK_ROWS), made on the shard's stream
just before the first of them, so the buffer those launches read is
written again only after them.

Every band takes the row kernel's row-invariant vectors
(gotoh_row.prepare over the whole padded width, prefix sums left to
right in float32 on the first shard's device) sliced to its columns, and
the row kernel's cell arithmetic, so the bands' decisions, score and end
state are the unsplit row kernel's bit for bit.  Columns past lb (the
padding among them) never reach a column at or before lb.

``schedule`` (and so ``forward``) launches the kernels (``launch``) on
CUDA shards and runs ``plain`` — the same block in PyTorch, row by row,
with the same strip handoff — on CPU shards; ``use_plain=True`` runs the
plain version on any device (the kernels' check on the card).  A launch
reads the band's state buffer slot ``band["slot"]`` and leaves its last
row in the other slot, which band["slot"] then names, so no block
overwrites a slot another block of the launch still reads.
"""

import ctypes
from collections import namedtuple
from contextlib import contextmanager, nullcontext
from functools import lru_cache

import torch

from kalign_tpu_torch.gpu import _cuda, gotoh_row, gotoh_wave
from kalign_tpu_torch.gpu.gotoh_row import NEG, RowLaunch

# rows per launch: ceil(la / 512) launches a band.  At the mesh_long root
# merge (4 bands on one H100) 256 rows left the card behind the host's
# enqueueing (8.9 ms of host time a merge against 8.3 of device time),
# 1,024 lengthened the pipeline's fill (9.8 ms of device time); 512 took
# 4.6 and 8.7 (PERF.md, chip_smoke.py --only mesh_sweep)
BLOCK_ROWS = 512
# a band source makes the match of this many launches' rows at a time
# (of one launch's where a launch takes more than BLOCK_ROWS): each fill
# costs the host a product, the preparation and their small operations
# (~0.4 ms), which at one launch's rows held the mesh_long root merge's
# band pipeline behind the host (PERF.md)
FILL_BLOCKS = 4
# rows a launch of a band alone on its card on the wave route: at 512 the
# host's queueing of KHV's 295k-row DPs (a launch, a strip copy and its
# events a band, a fill every 4) took ~0.9 s a DP against ~0.47 s of
# the card's (PERF.md)
ALONE_ROWS = 2048
STRIP = 5                  # floats per strip row: A, GA, GB, carry, u
STRIP_SLOT = 8             # floats per slot of a block's strip ring
# the plan (band_config): clusters of blocks of BLOCK_COLS columns or
# more (one block up to BLOCK_COLS)
BLOCK_COLS = 256
# the wave route past CLUSTER_MAX_WIDTH: at least WAVE_BANDS clusters of
# gotoh_row.WAVE_CLUSTER blocks a band, one block an SM, so that the two
# bands of a card on two shards (a two-shard merge on one card, chip_smoke's
# mesh_wide) are resident at once: an H100 80GB HBM3 holds 15 such
# clusters (cudaOccupancyMaxActiveClusters, PERF.md), 2 x 8 would not fit;
# more where the band's blocks would pass gotoh_row.WAVE_MAX_THREADS
# threads
WAVE_BANDS = 7
# a band alone on its card (alone) takes the wave route from this width
# on: one band on an H100 80GB HBM3, 2,048 rows, a row on one cluster of
# 16 blocks against the wave over 6-7 clusters of 8 blocks took 0.97 /
# 1.28 us at 16,384 columns, 1.63 / 1.28 at 24,576, 2.68 / 1.58 at
# 73,856; 11-15 clusters were slower than 7 at every width (chip_smoke.py
# --only mesh_sweep, PERF.md)
ALONE_WAVE_MIN = 24576

# launches by route: "wave" (gotoh_band_wave_kernel), "cluster"
# (gotoh_band_cluster_kernel)
launches = 0
cluster_launches = 0

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


def alone(shards) -> bool:
    """Whether every shard's band has its card to itself: shards on
    distinct cards (a list that repeats a card, or CPU shards, shares)."""
    devs = [sh.device for sh in shards]
    return all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs)


@lru_cache(maxsize=None)
def band_config(Wd: int, alone: bool = False):
    """The route of a band of Wd columns (a multiple of
    gotoh_row.COL_QUANTUM), by its width and whether it has its card to
    itself: a band alone on its card takes the wave route below
    gotoh_row.CLUSTER_MAX_WIDTH too, from ALONE_WAVE_MIN columns.
    Otherwise by its width alone: "cluster", one cluster of
    S <= 16 blocks of w columns each, w the least multiple of 128 (256
    past 1,024, where a block takes 8 columns a thread) of at least
    BLOCK_COLS (or Wd, where that is less) that keeps S = ceil(Wd / w)
    within 16, up to gotoh_row.CLUSTER_MAX_WIDTH (a RowLaunch); "wave"
    past that, gotoh_row.wave_config's plan over at least WAVE_BANDS
    clusters (a WaveLaunch: ``bands`` clusters of ``blocks`` blocks of
    ``band`` columns, its ``smem`` enough that no two blocks share an
    SM).  The blocks cover bands * blocks * band >= Wd columns and launch
    only where that is exactly Wd (``band_width`` pads to it); a block's
    ``smem`` holds the strip ring (``with_ring``; on the wave route one
    ring serves the mesh's strip and the wave's, as a block reads at most
    one).  Narrow blocks make a short row: at the mesh_long root merge's
    bands of 2,560 columns one block of 8 columns a thread took 1.7 us a
    row, clusters of 10 blocks of 256 columns 0.77 us (PERF.md;
    BLOCK_COLS rests on that shape and one other)."""
    q = gotoh_row.COL_QUANTUM
    if Wd <= 0 or Wd % q:
        raise ValueError(f"band Gotoh kernel: a band of {Wd} columns is not "
                         f"a multiple of {q}")
    if Wd > gotoh_row.CLUSTER_MAX_WIDTH or (alone and Wd >= ALONE_WAVE_MIN):
        widest = gotoh_row.WAVE_CLUSTER * gotoh_row.WAVE_MAX_THREADS * 8
        return gotoh_row.wave_config(Wd, max(WAVE_BANDS, -(-Wd // widest)))
    most = gotoh_row.CLUSTER_SIZES[-1]
    w = max(min(BLOCK_COLS, Wd), -(-(-(-Wd // most)) // q) * q)
    ch = 4 if w <= gotoh_row.BAND_CH4 else 8
    w = -(-w // (32 * ch)) * 32 * ch
    return with_ring(gotoh_row.band_config(-(-Wd // w), w, ch))


def with_ring(cfg: RowLaunch) -> RowLaunch:
    """A cluster plan with the strip ring in its shared memory
    (csrc/gotoh_row_body.cuh::wave_smem_bytes): a slot per match row of the
    ring and one more."""
    ring = 4 * STRIP_SLOT * (gotoh_row.CHUNKS[cfg.ch][1] + 1)
    return cfg._replace(smem=cfg.smem + ring)


def covered(cfg) -> int:
    """The columns a band plan's blocks cover."""
    return getattr(cfg, "bands", 1) * cfg.blocks * cfg.band


def block_rows(Wd: int, alone: bool = False) -> int:
    """Rows a launch of a band of Wd columns: ALONE_ROWS where it has its
    card to itself on the wave route, else BLOCK_ROWS."""
    if alone and band_config(Wd, True).route == "wave":
        return ALONE_ROWS
    return BLOCK_ROWS


def fill_rows(rows: int, L1p: int) -> int:
    """Rows a band source makes at a time: FILL_BLOCKS launches' rows, one
    launch's past BLOCK_ROWS, at most L1p."""
    return min(rows * (FILL_BLOCKS if rows <= BLOCK_ROWS else 1), L1p)


def band_width(W: int, n: int, alone: bool = False) -> int:
    """Columns of each of n bands over a row of W columns: ceil(W / n)
    rounded up to gotoh_row.COL_QUANTUM, then to the columns band_config's
    blocks cover (W padded to n times it, as mesh.py:516 pads W to a
    multiple of n); ``alone``: each band on a card of its own."""
    q = gotoh_row.COL_QUANTUM
    return covered(band_config(-(-(-(-W // n)) // q) * q, alone))


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


def plain(band, m, strip_in, strip_out, r0: int, nr: int, la: int,
          lb: int, first: bool):
    """Rows r0 + 1 .. r0 + nr of one band in PyTorch, m [nr, Wd] their
    match: the kernel's arithmetic (gotoh_row.plain's, with the strip at
    the band's left edge)."""
    state, dec, slot = band["state"], band["dec"], band["slot"]
    C_norm, C_term, gnC_norm, gnC_term, goB_s = band["colpen"]
    rowpen, cols_eps, row_term = band["rowpen"], band["cols_eps"], \
        band["row_term"]
    dev = m.device
    f32 = dict(dtype=torch.float32, device=dev)
    Wd = m.shape[1]
    cols = torch.arange(band["c0"] + 1, band["c0"] + Wd + 1, device=dev)
    is_term_col = cols == lb
    can_open = cols < lb
    neg = torch.full((1,), NEG, **f32)
    A, GA, GB = state[slot]
    strip_out[0, :3] = state[slot][:, Wd - 1]
    strip_out[0, 3:] = NEG
    for s in range(1, nr + 1):
        row = r0 + s
        r = row - 1
        goA_i, geA_i, tgeA_i, goA_prev, gb0_prev = rowpen[r].split(1)
        if first:
            eA = torch.full((1,), 0.0 if row == 1 else NEG, **f32)
            eGA, eGB, carry, lu = neg, gb0_prev, neg, neg
        else:
            eA, eGA, eGB = strip_in[s - 1, 0:1], strip_in[s - 1, 1:2], \
                strip_in[s - 1, 2:3]
            carry, lu = strip_in[s, 3:4], strip_in[s, 4:5]
        mr = m[s - 1] - torch.abs(cols_eps - row_term[r:r + 1])
        diagA = torch.cat([eA, A[:-1]])
        diagGA = torch.cat([eGA, GA[:-1]]) + goB_s
        diagGB = torch.cat([eGB, GB[:-1]]) + goA_prev
        best01 = torch.maximum(diagA, diagGA)
        A_row = torch.maximum(best01, diagGB) + mr

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
        A, GA, GB = A_row, GA_row, GB_row
        strip_out[s] = torch.stack([A_row[-1], GA_row[-1], GB_row[-1],
                                    cm[-1], u[-1]])
    state[slot ^ 1] = torch.stack([A, GA, GB])
    band["slot"] ^= 1


_max_active = {}


def max_active(cfg) -> int:
    """cudaOccupancyMaxActiveClusters of a band plan on the current card
    (cached per card and plan)."""
    key = (torch.cuda.current_device(), cfg)
    if key not in _max_active:
        out = ctypes.c_int(0)
        lib = _cuda.lib()
        if cfg.route == "wave":
            rc = lib.kt_gotoh_band_wave_max_active(
                cfg.threads, cfg.ch, cfg.blocks, ctypes.c_size_t(cfg.smem),
                ctypes.byref(out))
        else:
            rc = lib.kt_gotoh_band_cluster_max_active(
                cfg.threads, cfg.ch, cfg.blocks, ctypes.byref(out))
        _cuda.check(rc, "gotoh_mesh occupancy")
        _max_active[key] = out.value
    return _max_active[key]


def schedulable(cfg):
    """How many clusters of a band plan the current card holds at once;
    raises where it cannot hold one launch's (one cluster on the cluster
    route, every cluster of the band on the wave route, where a cluster
    waits on the one to its left): the launch would never run, or could
    wait on a cluster that never becomes resident."""
    held = max_active(cfg)
    need = getattr(cfg, "bands", 1)
    if held < need:
        raise RuntimeError(
            f"band Gotoh kernel: the card cannot schedule a cluster of "
            f"{cfg.blocks} blocks of {cfg.threads} threads and {cfg.smem} "
            "bytes of shared memory" + ("" if need == 1 else
                                        f" {need} times at once"))
    return held


def card_streams(shards, cfg):
    """The shards as one merge's band launches run on them: each on its
    own stream, unless the launches that can then run at once on a card
    (one a shard of it) would need more clusters resident than the card
    holds (wave route: the card's shards x cfg.bands > schedulable); then
    every shard of that card on its first shard's stream, so that its band
    launches run one at a time (their blocks of rows stay in schedule's
    order, which every dependence follows)."""
    if cfg.route != "wave":
        return list(shards)
    out = list(shards)
    by_card = {}
    for i, sh in enumerate(shards):
        if sh.stream is not None:
            by_card.setdefault(sh.device, []).append(i)
    for dev, idx in by_card.items():
        with torch.cuda.device(dev):
            held = schedulable(cfg)
        if len(idx) * cfg.bands > held:
            for i in idx:
                out[i] = Shard(shards[i].device, shards[idx[0]].stream)
    return out


# a band's launch: its route, the entry point, the band's pointers (before
# the strips) and what follows the per-launch arguments
BandPlan = namedtuple("BandPlan", "cfg entry ptrs args")

_BAND_KEYS = ("colpen", "rowpen", "cols_eps", "row_term", "state")


def band_plan(band) -> BandPlan:
    """One band's launch plan, checked once (call under
    ``torch.cuda.device`` of its tensors): its route (band["cfg"], which
    forward sets: band_config's for the width and the sharing), the entry
    point and the band's fixed arguments (those after the launch's slot);
    on the wave route also the band's strips between its clusters
    [bands, rows, gotoh_wave.STRIP] and their row counters (zero; never
    reset: they count rows from the problem's first), ``rows`` the most
    rows a launch of the band takes (band["rows"])."""
    Wd = band["dec"].shape[1]
    cfg = band["cfg"]
    _cuda.require_cuda("gotoh_mesh", *(band[k] for k in _BAND_KEYS),
                       band["dec"])
    if band["dec"].dtype != torch.int8:
        raise ValueError("gotoh_mesh: int8 decisions")
    if covered(cfg) != Wd:
        raise ValueError(f"gotoh_mesh: a band of {Wd} columns is not one "
                         "that band_width gives")
    lib = _cuda.lib()
    if lib.kt_gotoh_band_smem_bytes(cfg.threads, cfg.ch) != \
            gotoh_row.wave_smem_bytes(cfg.threads, cfg.ch):
        raise RuntimeError("band Gotoh kernel: shared-memory size differs "
                           "between csrc/gotoh_mesh.cu and band_config")
    schedulable(cfg)
    ptrs = tuple(band[k].data_ptr() for k in _BAND_KEYS)
    if cfg.route == "cluster":
        return BandPlan(cfg, lib.kt_gotoh_band_cluster, ptrs,
                        (cfg.threads, cfg.ch, cfg.blocks))
    R = band["rows"]
    dev = band["dec"].device
    band["wstrip"] = torch.empty((cfg.bands, R, gotoh_wave.STRIP),
                                 dtype=torch.float32, device=dev)
    band["ready"] = torch.zeros(cfg.bands, dtype=torch.int32, device=dev)
    return BandPlan(cfg, lib.kt_gotoh_band_wave, ptrs, (
        band["wstrip"].data_ptr(), band["ready"].data_ptr(), R,
        gotoh_wave.EVERY, cfg.threads, cfg.ch, cfg.blocks, cfg.bands,
        ctypes.c_size_t(cfg.smem)))


def launch(band, m, strip_in, strip_out, r0: int, nr: int, la: int,
           lb: int, first: bool):
    """Launch band_config's route of csrc/gotoh_mesh.cu on one band's
    CUDA tensors: rows r0 + 1 .. r0 + nr, m [nr, Wd] their match
    (contiguous float32), the left band's strip_in (None on the first
    band), this band's strip_out ([>= nr + 1, STRIP]); the state read
    from slot band["slot"], which then flips."""
    global launches, cluster_launches
    dev = band["dec"].device
    with torch.cuda.device(dev):
        plan = band.get("plan")
        if plan is None:
            plan = band["plan"] = band_plan(band)
        _cuda.require_cuda("gotoh_mesh", m, strip_out,
                           *(() if first else (strip_in,)))
        if tuple(m.shape) != (nr, band["dec"].shape[1]) or \
                m.dtype != torch.float32 or not m.is_contiguous():
            raise ValueError("gotoh_mesh: a launch's match is not its rows "
                             "of the band, contiguous float32")
        if strip_out.numel() < (nr + 1) * STRIP or (
                not first and strip_in.numel() < (nr + 1) * STRIP):
            raise ValueError("gotoh_mesh: a strip holds fewer than nr + 1 "
                             "rows")
        if plan.cfg.route == "wave" and nr > band["rows"]:
            raise ValueError("gotoh_mesh: a launch of more rows than the "
                             "wave strips hold")
        rc = plan.entry(
            m.data_ptr(), *plan.ptrs,
            None if first else strip_in.data_ptr(), strip_out.data_ptr(),
            band["dec"].data_ptr(), band["dec"].shape[1], r0, nr, la, lb,
            band["c0"], int(first), band["slot"], *plan.args,
            ctypes.c_void_p(_cuda.stream(dev)))
    _cuda.check(rc, "gotoh_mesh")
    band["slot"] ^= 1
    if plan.cfg.route == "cluster":
        cluster_launches += 1
    else:
        launches += 1


def block(band, r0: int, nr: int):
    """The match of the band's rows [r0, r0 + nr): a whole band's rows,
    or rows of the ring's buffer f % 2 that holds the f-th fill of
    ``fill`` rows, which the source makes there where the buffer does not
    hold it yet."""
    ring = band["ring"]
    if ring is None:
        return band["source"](r0, r0 + nr, None)
    F = band["fill"]
    f, lo = divmod(r0, F)
    if band["filled"] != f:
        r1 = min((f + 1) * F, band["dec"].shape[0])
        band["source"](f * F, r1, ring[f % 2][:r1 - f * F])
        band["filled"] = f
    return ring[f % 2][lo:lo + nr]


def schedule(shards, bands, la: int, lb: int, rows: int = BLOCK_ROWS,
             use_plain: bool = False):
    """The block-pipelined wavefront over the bands (bands[d] on
    shards[d], each with its match source, state buffer and decision
    rows): at step s, shard d makes the match of its block s - d (block)
    and runs the block.  Fills every band's dec rows < la and
    leaves row la's state in state[band["slot"]].  Kernel blocks on CUDA
    shards, plain on CPU shards or with use_plain.  Each band's strips
    (one per block) are allocated once, with a copy on the next shard's
    card where that is another; each shard records one event, again at
    every block: a step walks the shards right to left, so shard d + 1
    waits on shard d's record of the block before shard d records the
    next one."""
    n = len(shards)
    blocks = -(-la // rows)
    if blocks == 0:
        return
    outs, ins = [], [None]
    for sh in shards:
        with on(sh):
            outs.append(torch.empty((blocks, rows + 1, STRIP),
                                    dtype=torch.float32, device=sh.device))
    for d in range(1, n):
        src, sh = outs[d - 1], shards[d]
        if sh.device != shards[d - 1].device:
            with on(sh):
                src = torch.empty_like(src, device=sh.device)
        elif sh.stream is not None:
            src.record_stream(sh.stream)
        ins.append(src)
    outs_b = [o.unbind(0) for o in outs]
    ins_b = [None] + [i.unbind(0) for i in ins[1:]]
    done = [None if sh.stream is None else torch.cuda.Event()
            for sh in shards]
    use_kernel = not use_plain
    for s in range(blocks + n - 1):
        for d in reversed(range(n)):
            b = s - d
            if not 0 <= b < blocks:
                continue
            sh = shards[d]
            r0 = b * rows
            with on(sh):
                if d:
                    wait(sh, done[d - 1])
                run = launch if use_kernel and sh.device.type == "cuda" \
                    else plain
                nr = min(rows, la - r0)
                run(bands[d], block(bands[d], r0, nr),
                    ins_b[d][b] if d else None, outs_b[d][b], r0, nr, la,
                    lb, d == 0)
                if d + 1 < n:
                    if ins[d + 1] is not outs[d]:
                        ins_b[d + 1][b].copy_(outs_b[d][b], non_blocking=True)
                    if done[d] is not None:
                        done[d].record(sh.stream)


RING_ALIGN = 256


def buffer_bytes(L1p: int, Wd: int, fill: int) -> int:
    """Bytes of a band's decisions (int8 [L1p, Wd]) and its ring of two
    match buffers (float32 [2, fill, Wd]) in one buffer (band_buffers)."""
    dec = -(-L1p * Wd // RING_ALIGN) * RING_ALIGN
    return dec + 2 * 4 * fill * Wd


def band_buffers(L1p: int, Wd: int, fill: int, device, alloc=None):
    """A band's decisions [L1p, Wd] int8, zero, and its ring [2, fill, Wd]
    float32 (None where fill is 0): in alloc(buffer_bytes) where given,
    a uint8 buffer that may be longer and may hold anything, else
    allocated here."""
    if alloc is None:
        ring = None if not fill else torch.empty(
            (2, fill, Wd), dtype=torch.float32, device=device)
        return torch.zeros((L1p, Wd), dtype=torch.int8, device=device), ring
    buf = alloc(buffer_bytes(L1p, Wd, fill))
    off = buffer_bytes(L1p, Wd, 0)
    dec = buf[:L1p * Wd].view(torch.int8).view(L1p, Wd)
    dec.zero_()
    ring = None if not fill else buf[off:off + 8 * fill * Wd].view(
        torch.float32).view(2, fill, Wd)
    return dec, ring


def end_values(band, lb: int):
    """Score and end state at column lb of the band holding it, from its
    last row's state, row la's (gotoh_row.plain's pick): tensors [1]."""
    c0 = band["c0"]
    A, GA, GB = band["state"][band["slot"]][:, lb - 1 - c0:lb - c0]
    ea, ega, egb = (torch.clamp(x, min=NEG) for x in (A, GA, GB))
    score = torch.maximum(torch.maximum(ea, ega), egb)
    st = torch.where(ega > ea, torch.where(egb > ega, 2, 1),
                     torch.where(egb > ea, 2, 0)).to(torch.int32)
    return score, st


def forward(shards, match_bands, prep, la: int, lb: int,
            rows: int = BLOCK_ROWS, use_plain: bool = False, alloc=None):
    """One problem's column-sharded DP.  match_bands[d], the match of
    band d on shards[d] (the centering bias not yet subtracted where prep
    carries it, as for the row kernel): a [L1p, Wd] tensor, or a source
    source(r0, r1, out) giving the rows [r0, r1) as a [r1 - r0, Wd]
    tensor (made in out, the first r1 - r0 rows of a buffer of a ring of
    two of fill_rows(rows) rows on the shard, block); prep =
    gotoh_row.prepare of the problem over the padded width n * Wd, on
    shards[0]'s device, queued there.  The bands take band_config's plan
    for their width and whether each has its card to itself (alone;
    band["cfg"]), and run on card_streams' streams, joined back onto
    each shard's own before this returns.  alloc(d, nbytes), where given,
    holds band d's decisions and ring (a uint8 tensor of at least nbytes
    on its device, ``band_buffers``), else they are allocated here.
    Returns (bands, score [1], state
    [1] int32 on shards[0]'s device); each band's decision rows < la are
    its dec (rows past la are 0)."""
    L1p = prep["rowpen"].shape[1]
    Wd = prep["cols_eps"].shape[1] // len(shards)
    cfg = band_config(Wd, alone(shards))
    run = card_streams(shards, cfg)
    ready = event(shards[0])
    bands = []
    for d, sh in enumerate(run):
        with on(sh):
            wait(sh, ready)
            band = band_inputs(prep, d * Wd, (d + 1) * Wd, sh.device)
            src = match_bands[d]
            fill = fill_rows(rows, L1p) if callable(src) else 0
            band["dec"], band["ring"] = band_buffers(
                L1p, Wd, fill, sh.device,
                None if alloc is None else lambda n, d=d: alloc(d, n))
            if callable(src):
                band["source"] = src
                band["fill"] = fill
                band["filled"] = None
            else:
                band["source"] = lambda r0, r1, out, m=src: m[r0:r1]
            band["state"] = init_state(band)
            band["cfg"] = cfg
            band["slot"] = 0
            band["rows"] = rows
            bands.append(band)
    if shards[0].stream is not None:
        for x in prep.values():
            for sh in run[1:]:
                if sh.device == shards[0].device:
                    x.record_stream(sh.stream)
    schedule(run, bands, la, lb, rows, use_plain)
    for sh, own, band in zip(run, shards, bands):
        if own.stream is not None and own.stream != sh.stream:
            # end_values, the walk and the caller read the band on the
            # shard's own stream
            wait(own, event(sh))
            for t in (band["dec"], band["state"]):
                t.record_stream(own.stream)
    if lb == 0:
        with on(shards[0]):
            score = prep["lb0_score"].clone()
            st = torch.full((1,), 2, dtype=torch.int32,
                            device=shards[0].device)
        return bands, score, st
    o = (lb - 1) // Wd
    with on(shards[o]):
        score, st = end_values(bands[o], lb)
        done = event(shards[o])
    with on(shards[0]):
        wait(shards[0], done)
        if o and shards[0].stream is not None and \
                shards[o].device == shards[0].device:
            # read on the first shard's stream from here on
            score.record_stream(shards[0].stream)
            st.record_stream(shards[0].stream)
        return bands, score.to(shards[0].device), st.to(shards[0].device)
