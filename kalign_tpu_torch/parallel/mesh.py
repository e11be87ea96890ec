"""Multi-GPU sharding for the MSA pipeline.

Counterpart of kalign_tpu/parallel/mesh.py.  The parallel axes are the
reference's:

  * anchor distances — the N x K bit-parallel problems, sequence rows
    sharded over every shard (``sharded_anchor_distances``);
  * guide-tree levels — a merge bucket's problems sharded on their batch
    axis (``sharded_bucket_step``);
  * one DP too wide for the row kernel's registers, or (a consistency
    map) too big for one card — its columns in bands over the shards
    (``LongQueue``, ``sharded_long_gotoh``: the band
    kernel of gpu/gotoh_mesh.py, csrc/gotoh_mesh.cu), each band's match
    made a block of rows at a time (``band_source``), the path walked
    band by band on the bands' own cards (``walk_bands``), DPs queued
    ahead of their walks as far as the cards hold their bands.

A mesh is a [data, model] array of torch devices (``make_mesh``, the
reference's factorisation).  Every shard keeps its own CUDA stream on
its card, so a list that repeats one card (``["cuda:0"] * 4``) runs four
shards side by side on it; ``["cpu"] * n`` runs the kernels' plain
versions shard after shard.  Each sharded call queues every shard's work
on its stream (inputs copied from pinned host memory with
``non_blocking``) before it fetches any result, one fetch per shard.

Across processes (parallel/distributed.py): after ``init_distributed``
``make_mesh`` gathers every process's devices into one mesh; a process
runs the shards it owns and the host results reach every process
through gloo's ``all_gather_object`` (``gather``, timed in
``Mesh.gathers``), as the reference's _from_global gathers to every host
(the gathers are host-side there too).  The engine runs on such a mesh
(every process builds the same tree and maps on its own first shard,
``same_on_every_process`` checks it); the column-sharded DP takes a mesh
within one process, as the reference's fetch of its decisions
(mesh.py:487) does.
"""

import hashlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kalign_tpu_torch.gpu import distances, gotoh_mesh, gotoh_row
from kalign_tpu_torch.gpu import traceback as tb
from kalign_tpu_torch.gpu.gotoh_mesh import Shard, event, on
from kalign_tpu_torch.utils.logging import span


def _world():
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: unsupported device {d}")
    return d


class Mesh:
    """Shards over a [data, model] array of devices.  ``ranks`` holds the
    process that owns each shard; ``shards`` the flattened mesh, each
    with its stream (None on the CPU and for another process's shards);
    ``local`` the flat indices this process runs; ``gathers`` the calls
    and seconds of ``gather`` across processes; ``walkers`` each card's
    walk stream (``walker``)."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray, rank: int):
        self.devices = devices
        self.ranks = ranks
        self.rank = rank
        self.shape = devices.shape
        flat = list(devices.reshape(-1))
        owners = list(ranks.reshape(-1))
        self.local = [k for k, r in enumerate(owners) if r == rank]
        self.gathers = {"calls": 0, "s": 0.0}
        self.walkers = {}
        self.shards = []
        for k, d in enumerate(flat):
            mine = owners[k] == rank and d.type == "cuda"
            self.shards.append(Shard(
                d, torch.cuda.Stream(device=d) if mine else None))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def processes(self) -> int:
        return len(set(self.ranks.reshape(-1).tolist()))

    @property
    def spans_processes(self) -> bool:
        return self.processes > 1

    @property
    def cards(self) -> int:
        """Distinct (process, device) pairs of the mesh: two processes'
        ``cuda:0`` count as two cards (card_keys)."""
        return len(set(card_keys(self)))


def card_keys(mesh) -> list:
    """Each shard's card as (owning process, device string), in flat
    order."""
    return list(zip(mesh.ranks.reshape(-1).tolist(),
                    (str(d) for d in mesh.devices.reshape(-1))))


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over every visible CUDA card, or over ``devices`` (which may
    repeat a card, or be ["cpu"] * n); the first n_devices of them.
    model = the largest power of two <= sqrt(n) that divides n and data
    the rest, unless data is given (mesh.py:31-49).  Raises without a
    card: there is no CPU fallback.  Under init_distributed every
    process's devices join one mesh, in rank order."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA card is visible (pass "
                               "devices=['cpu'] * n to run the plain "
                               "versions)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if any(d.type == "cuda" for d in devices) and \
            not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available")
    rank, world = _world()
    ranks = [rank] * len(devices)
    if world > 1:
        import torch.distributed as dist
        every = [None] * world
        dist.all_gather_object(every, [str(d) for d in devices])
        devices = [torch.device(d) for part in every for d in part]
        ranks = [r for r, part in enumerate(every) for _ in part]
    if n_devices is not None:
        devices, ranks = devices[:n_devices], ranks[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if data is None:
        model = 1
        while (model * 2) * (model * 2) <= n:
            model *= 2
        while n % model:
            model //= 2
        data = n // model
    else:
        model = n // data
    cut = data * model
    arr = np.empty(cut, dtype=object)
    arr[:] = devices[:cut]
    return Mesh(arr.reshape(data, model),
                np.asarray(ranks[:cut]).reshape(data, model), rank)


def pad_rows(a: np.ndarray, to: int, fill=0) -> np.ndarray:
    if a.shape[0] == to:
        return a
    pad = np.full((to - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def put(x, shard: Shard) -> torch.Tensor:
    """A host array or a tensor on the shard's device, for its stream
    (call inside ``on(shard)``): from the host pinned and asynchronous;
    from another card copied after both cards' current streams; on the
    shard's own card taken as it is, kept from the allocator until the
    stream is done with it (the stream waits on its making: long_operands'
    ``ready``)."""
    t = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(x))
    if shard.device.type != "cuda":
        return t.to(shard.device)
    if t.device.type == "cpu":
        return t.contiguous().pin_memory().to(shard.device,
                                              non_blocking=True)
    if t.device == shard.device:
        if shard.stream is not None:
            t.record_stream(shard.stream)
        return t
    return t.to(shard.device, non_blocking=True)


def fetch(mesh: Mesh, outs: dict) -> dict:
    """{shard: tensor or tuple of tensors} of this process's shards to
    host numpy, one transfer per tensor on each shard's stream; across
    processes the results of every shard reach every process."""
    host = {}
    for k, out in outs.items():
        with on(mesh.shards[k]):
            host[k] = (tuple(x.cpu().numpy() for x in out)
                       if isinstance(out, tuple) else out.cpu().numpy())
    return gather(mesh, host)


def gather(mesh: Mesh, local: dict) -> dict:
    """Host results keyed by shard (or process), from every process of
    the mesh; each call and its seconds counted in mesh.gathers."""
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist
    t0 = time.perf_counter()
    every = [None] * _world()[1]
    dist.all_gather_object(every, local)
    merged = {}
    for part in every:
        merged.update(part)
    mesh.gathers["calls"] += 1
    mesh.gathers["s"] += time.perf_counter() - t0
    return merged


def same_on_every_process(mesh: Mesh, what: str, *arrays) -> None:
    """Raise where the processes of a mesh that spans them hold other
    bytes in arrays (one small gather of a digest); names the processes
    that differ from the first.  Nothing to check in one process."""
    if not mesh.spans_processes:
        return
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    every = gather(mesh, {mesh.rank: h.hexdigest()})
    first = every[min(every)]
    odd = sorted(r for r, d in every.items() if d != first)
    if odd:
        raise RuntimeError(
            f"processes {odd} built other {what} than process {min(every)} "
            "(digests " + ", ".join(f"{r}: {every[r][:12]}"
                                    for r in sorted(every)) + ")")


# ---------------------------------------------------------------------------
# sharded distance matrix
# ---------------------------------------------------------------------------

def sharded_anchor_distances(mesh: Mesh, tokens: np.ndarray,
                             lengths: np.ndarray,
                             anchors: Sequence[int]) -> np.ndarray:
    """Distance of every sequence to every anchor, the sequence rows
    sharded over the mesh (mesh.py:183-263): rows padded to a multiple of
    the shard count (length 1), each shard running the BPM kernels on its
    rows' N_d x K pairs (gpu/distances.py: the longer side the text),
    the integer distances gathered, then the length bias added in
    float64 and narrowed.  tokens [N, Lmax] uint8, lengths [N].  The
    same bits as the one-card distances."""
    N = tokens.shape[0]
    n = mesh.size
    Np = -(-N // n) * n
    per = Np // n
    lengths = np.asarray(lengths, np.int32)
    anchors = np.asarray(anchors, np.int64)
    tokens_p = pad_rows(tokens, Np)
    lengths_p = pad_rows(lengths, Np, fill=1)
    outs = {}
    for k in mesh.local:
        rows = slice(k * per, (k + 1) * per)
        # the shard's rows, then the anchors' rows, whose indices follow
        tok_k = np.concatenate([tokens_p[rows], tokens[anchors]])
        len_k = np.concatenate([lengths_p[rows], lengths[anchors]])
        with on(mesh.shards[k]):
            # (the anchors' own rows against the anchors are not kept)
            outs[k] = distances.raw_distances_device(
                tok_k, len_k, np.arange(per, per + len(anchors)),
                mesh.shards[k].device)[:per * len(anchors)]
    host = fetch(mesh, outs)
    dm = np.concatenate([host[k].reshape(per, len(anchors))
                         for k in range(n)])[:N]
    return dm.astype(np.float32) + distances.length_bias(lengths, anchors)


def anchor_distances(mesh: Mesh, codes, anchors) -> np.ndarray:
    """sharded_anchor_distances of encoded sequences, in the native tree
    builder's layout (tpu/engine.py:298-315)."""
    tokens, lens = distances.token_table(codes)
    return distances.tree_layout(
        sharded_anchor_distances(mesh, tokens, lens, list(anchors)))


# ---------------------------------------------------------------------------
# batched level-synchronous DP
# ---------------------------------------------------------------------------

def batch_counts(mesh: Mesh, B: int):
    """Problems per shard of a batch of B: spread evenly over the mesh's
    cards (card_keys: a card per process and device; the first cards
    take one more), then over each card's shards in shard order; a shard
    may get none.  A multiple of the shard count on a mesh whose cards
    hold as many shards each splits evenly."""
    flat = card_keys(mesh)
    cards = list(dict.fromkeys(flat))
    counts = [0] * len(flat)
    for c, card in enumerate(cards):
        n = B // len(cards) + (c < B % len(cards))
        mine = [k for k, d in enumerate(flat) if d == card]
        for i, k in enumerate(mine):
            counts[k] = n // len(mine) + (i < n % len(mine))
    return counts


def _batch_slices(mesh: Mesh, B: int):
    """Each local shard's slice of a batch of B (batch_counts' split),
    for the shards that get problems."""
    counts = batch_counts(mesh, B)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return {k: slice(int(starts[k]), int(starts[k + 1])) for k in mesh.local
            if counts[k]}


def batched_gotoh(mesh: Mesh, match, pens_cols, pens_rows, la, lb):
    """A batch of padded problems sharded over the mesh (mesh.py:270-285):
    each shard runs gotoh_row.forward on its problems.  Returns (dec
    [B, L1p, L2p] int8 in the row kernel's layout, score [B], end state
    [B]) as numpy."""
    outs = {}
    for k, sl in _batch_slices(mesh, match.shape[0]).items():
        sh = mesh.shards[k]
        with on(sh):
            outs[k] = gotoh_row.forward(*(put(x[sl], sh) for x in (
                match, pens_cols, pens_rows, np.asarray(la, np.int32),
                np.asarray(lb, np.int32))))
    host = fetch(mesh, outs)
    return tuple(np.concatenate([host[k][i] for k in sorted(host)])
                 for i in range(3))


def dispatch_bucket_step(mesh: Mesh, lhs, rhs, pc, pr, la, lb, eps,
                         bonus=None) -> dict:
    """Queue one merge bucket with its batch axis sharded over the mesh
    (mesh.py:490-546): on each shard the match product, the centering
    bias and the compact consistency bonus (added on the card by
    gpu/prepare.py::prepare_match), gotoh_row.forward and the walk
    (gpu/engine.py::row_route).  Host numpy inputs, split by
    batch_counts (the reference's padded batches evenly; past the
    register row kernel's widths real problems only, a shard perhaps
    idle); bonus None or (per_w, apos_r, conf_r, apos_c, conf_c).
    Returns {shard: (steps, n, score)} on the shards' devices, for the
    shards that got problems."""
    from kalign_tpu_torch.gpu.engine import row_route
    outs = {}
    for k, sl in _batch_slices(mesh, lhs.shape[0]).items():
        sh = mesh.shards[k]
        with on(sh):
            args = [put(x[sl], sh) for x in (lhs, rhs, pc, pr, la, lb, eps)]
            bonus_d = None
            if bonus is not None:
                bonus_d = (torch.tensor(np.float32(bonus[0])).to(sh.device),
                           *(put(a[sl], sh) for a in bonus[1:]))
            outs[k] = row_route(*args, bonus_d)
    return outs


def collect_bucket_step(mesh: Mesh, outs: dict):
    """Fetch a dispatched bucket: ([steps per problem], scores float64),
    in batch order."""
    host = fetch(mesh, outs)
    steps, scores = [], []
    for k in sorted(host):
        s, n, sc = host[k]
        steps.extend(s[b, :n[b]] for b in range(len(n)))
        scores.append(sc)
    return steps, np.concatenate(scores).astype(np.float64)


def sharded_bucket_step(mesh: Mesh, lhs, rhs, pc, pr, la, lb, eps,
                        bonus=None):
    """dispatch_bucket_step, then collect_bucket_step."""
    return collect_bucket_step(mesh, dispatch_bucket_step(
        mesh, lhs, rhs, pc, pr, la, lb, eps, bonus))


# ---------------------------------------------------------------------------
# one problem with its columns sharded
# ---------------------------------------------------------------------------

def _one_process(mesh: Mesh):
    if mesh.spans_processes:
        raise ValueError("the column-sharded DP takes a mesh within one "
                         "process")
    return mesh.shards


def sharded_long_gotoh(mesh: Mesh, match, pens_cols, pens_rows, la: int,
                       lb: int, rows: int = gotoh_mesh.BLOCK_ROWS):
    """One Gotoh problem with its column axis in bands over the mesh
    (mesh.py:288-487), the bands' blocks of rows pipelined by
    gotoh_mesh.forward.  match [L1, W] f32 (the bias in it; W a multiple
    of the shard count), pens_cols [3, W + 1], pens_rows [3, L1 + 1].
    The bands are gotoh_mesh.band_width wide, W padded with zero match
    and penalties to n of them (past lb, so no bit of the result moves).
    Returns (dec [L1, W] int8 in the row kernel's layout, rows >= la
    zero, score, end state).  rows: the rows of a block."""
    shards = _one_process(mesh)
    L1, W = match.shape
    n = len(shards)
    if W % n:
        raise ValueError(f"width {W} is not a multiple of {n} shards")
    Wd = gotoh_mesh.band_width(W, n, gotoh_mesh.alone(shards))
    Wp = Wd * n
    pc = np.pad(np.asarray(pens_cols, np.float32), ((0, 0), (0, Wp - W)))
    mp = np.pad(np.asarray(match, np.float32), ((0, 0), (0, Wp - W)))
    with on(shards[0]):
        z = torch.zeros(1, dtype=torch.float32, device=shards[0].device)
        prep = gotoh_row.prepare(
            put(pc[None], shards[0]),
            put(np.asarray(pens_rows, np.float32)[None], shards[0]),
            put(np.array([la], np.int32), shards[0]),
            put(np.array([lb], np.int32), shards[0]), z, z)
    bands = []
    for d, sh in enumerate(shards):
        with on(sh):
            bands.append(put(mp[:, d * Wd:(d + 1) * Wd], sh))
    bands, score, st = gotoh_mesh.forward(shards, bands, prep, la, lb, rows)
    dec = np.concatenate([fetch(mesh, {d: b["dec"]})[d]
                          for d, b in enumerate(bands)], axis=1)[:, :W]
    with on(shards[0]):
        return dec, float(score.cpu()[0]), int(st.cpu()[0])


def band_parts(L1p: int, Wd: int, rows: int):
    """Device bytes of one band of a column-sharded DP on its shard: (its
    decisions and its ring of two float32 match buffers of fill_rows'
    rows, gotoh_mesh.buffer_bytes: what LongQueue keeps in its buffers;
    the rest: the state [2, 3, Wd], the strips (one of rows + 1 a block,
    and a copy for the next shard) and the operands (the rows' lhs, the
    band's rhs))."""
    blocks = -(-L1p // rows)
    return (gotoh_mesh.buffer_bytes(L1p, Wd, gotoh_mesh.fill_rows(rows, L1p)),
            4 * 6 * Wd + 2 * 4 * blocks * (rows + 1) * gotoh_mesh.STRIP
            + 4 * 23 * (L1p + Wd))


def band_bytes(L1p: int, Wd: int, rows: int) -> int:
    """Device bytes of one band of a column-sharded DP on its shard (both
    of band_parts)."""
    return sum(band_parts(L1p, Wd, rows))


def long_shortfall(mesh: Mesh, L1p: int, W: int,
                   rows: int = gotoh_mesh.BLOCK_ROWS, held=None) -> list:
    """The cards that cannot hold the bands of one more L1p x W
    column-sharded DP that their shards run (band_bytes for each, against
    card_bytes: what the DPs in flight hold is counted there already;
    held(d, nbytes), where given, the bytes band d needs for its buffers
    beyond those a LongQueue keeps for it): [(device, bytes needed, bytes
    it has)].  Off the card nothing is short."""
    from kalign_tpu_torch.gpu.engine import card_bytes
    shards = _one_process(mesh)
    n = len(shards)
    Wd = gotoh_mesh.band_width(W, n, gotoh_mesh.alone(shards))
    bufs, rest = band_parts(L1p, Wd, rows)
    need = {}
    for d, sh in enumerate(shards):
        more = bufs if held is None else held(d, bufs)
        need[sh.device] = need.get(sh.device, 0) + more + rest
    out = []
    for dev, bytes_ in need.items():
        have = card_bytes(dev)
        if have is not None and bytes_ > have:
            out.append((dev, bytes_, have))
    return out


def check_long_fits(mesh: Mesh, L1p: int, W: int,
                    rows: int = gotoh_mesh.BLOCK_ROWS,
                    what: str = "merge", held=None) -> None:
    """The column-sharded route's memory guard, before anything of the
    DP is allocated: raises MemoryError, naming the width, where a card
    cannot hold the bands of one L1p x W DP (``what``: a merge or a map
    DP) that its shards run (long_shortfall, held as there).  Each band's
    decisions stay on its card: nothing is gathered for the walk."""
    short = long_shortfall(mesh, L1p, W, rows, held)
    if short:
        dev, bytes_, have = short[0]
        n = mesh.size
        Wd = gotoh_mesh.band_width(W, n, gotoh_mesh.alone(mesh.shards))
        raise MemoryError(
            f"a {L1p} x {W} {what} in {n} bands of {Wd} columns needs "
            f"{bytes_ / 2 ** 30:.1f} GiB of device memory on {dev} "
            f"(decisions, match blocks, strips); it has "
            f"{have / 2 ** 30:.1f} GiB free")


def band_source(lhs, rhs_t, one, bonus, c0: int):
    """source(r0, r1, out=None) of one band, on its shard (call inside
    ``on(shard)``): the fp32 product of the rows [r0, r1) of lhs
    [1, L1p, nc] with the band's columns rhs_t [1, nc, Wd], in out where
    given ([r1 - r0, Wd]; the match lands there), then, with a bonus, the
    centering bias and the bonus added in place at row0 = r0, col0 = c0
    (prepare.prepare_match: csrc/prepare_match.cu on a card; one = the
    problem's (la, lb, eps) [1] tensors, bonus the band's compact tuple,
    its row vectors cut to the rows), as gpu/engine.py::bucket_match
    makes the whole match.  Returns [r1 - r0, Wd]."""
    from kalign_tpu_torch.gpu.prepare import cut, prepare_match

    def source(r0, r1, out=None):
        m = torch.bmm(lhs[:, r0:r1], rhs_t,
                      out=None if out is None else out.unsqueeze(0))
        if bonus is not None:
            done = prepare_match(m, *one, cut(bonus, r0, r1), col0=c0,
                                 row0=r0)
            if done is not m:       # the plain version's new tensor
                m.copy_(done)
        return m[0]
    return source


def long_operands(mesh: Mesh, lhs, rhs, pc, pr, la: int, lb: int,
                  eps: float, bonus=None):
    """The column-sharded route's inputs of one DP, queued: W padded to n
    bands of gotoh_mesh.band_width (pc with zeros, as tpu/engine.py:
    516-521 pads it to a multiple of the shard count), the row-invariant
    vectors over the padded width on the first shard (gotoh_row.prepare),
    and on each shard its band's source (band_source: the operands of
    its rows and columns on its card, the match made a block of rows at
    a time; no band's whole match is made).  lhs [L1p, 23], rhs [L2p,
    23], pc [3, L2p + 1], pr [3, L1p + 1]: host arrays (a merge's) or
    tensors on one card (a map DP's, made there on its current stream);
    bonus None or the compact tuple of host arrays.  Without a bonus the
    kernel subtracts the bias.  Returns (band sources, prep, Wp)."""
    shards = _one_process(mesh)
    n = len(shards)
    lhs, rhs, pc, pr = (torch.as_tensor(x) for x in (lhs, rhs, pc, pr))
    L2p = rhs.shape[0]
    Wd = gotoh_mesh.band_width(L2p, n, gotoh_mesh.alone(shards))
    Wp = Wd * n
    pad = torch.nn.functional.pad
    pc_p = pad(pc, (0, Wp - L2p))
    rhs_p = pad(rhs, (0, 0, 0, Wp - L2p))
    ready = None
    if lhs.device.type == "cuda":
        # the operands' making on their card's current stream: the shard
        # of that card reads them on its own stream (put)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(lhs.device))

    def made(sh):
        if ready is not None and sh.stream is not None and \
                sh.device == lhs.device:
            sh.stream.wait_event(ready)
    sh0 = shards[0]
    with on(sh0):
        made(sh0)
        la_d = put(np.array([la], np.int32), sh0)
        lb_d = put(np.array([lb], np.int32), sh0)
        slope = lb_d.to(torch.float32) / torch.clamp(
            la_d.to(torch.float32), min=1.0)
        eps_k = put(np.array([eps], np.float32), sh0)
        if bonus is not None:
            # bias and bonus are in the match: the kernel adds none
            slope, eps_k = torch.zeros_like(slope), torch.zeros_like(eps_k)
        prep = gotoh_row.prepare(put(pc_p[None], sh0), put(pr[None], sh0),
                                 la_d, lb_d, slope, eps_k)
    if bonus is not None:
        per_w, apr, cfr, apc, cfc = bonus
        apc = np.pad(apc, ((0, 0), (0, Wp - L2p)), constant_values=-1)
        cfc = np.pad(cfc, ((0, 0), (0, Wp - L2p)))
    sources = []
    for d, sh in enumerate(shards):
        c0, c1 = d * Wd, (d + 1) * Wd
        with on(sh):
            made(sh)
            one = b = None
            if bonus is not None:
                one = [put(np.array([x], dt), sh) for x, dt in (
                    (la, np.int32), (lb, np.int32), (eps, np.float32))]
                b = (torch.tensor(np.float32(per_w)).to(sh.device),
                     put(apr[None], sh), put(cfr[None], sh),
                     put(apc[None, :, c0:c1], sh),
                     put(cfc[None, :, c0:c1], sh))
            sources.append(band_source(
                put(lhs[None], sh), put(rhs_p[None, c0:c1], sh).transpose(
                    1, 2), one, b, c0))
    return sources, prep, Wp


def walker(mesh: Mesh, d: int) -> Shard:
    """Shard d's card with the mesh's walk stream there (one a card, of
    high priority, made at first use): the walks run beside the next
    DP's bands, which run on the shards' own streams."""
    sh = mesh.shards[d]
    if sh.stream is None:
        return sh
    if sh.device not in mesh.walkers:
        mesh.walkers[sh.device] = torch.cuda.Stream(device=sh.device,
                                                    priority=-1)
    return Shard(sh.device, mesh.walkers[sh.device])


def walk_bands(mesh: Mesh, bands, la: int, lb: int, st, max_steps: int):
    """The path of a column-sharded DP whose forward has finished, walked
    on the bands' own cards (bands[d] on mesh.shards[d], each its
    decisions [L1p, Wd] of the columns d Wd + 1 .. (d + 1) Wd): from
    (la, lb) in the end state st ([1] int32) on the band that holds
    column lb, right to left, each band's walk (traceback.walk_band, on
    its card's walk stream) stopping where its column reaches the band's
    first and handing the cell and the state (three int32) to the band
    on its left, on that band's card.  No decision leaves its card.
    Returns (steps int8 in forward order: the bands' parts concatenated
    from band 0 on, band crossings, transfers to the host)."""
    Wd = bands[0]["dec"].shape[1]
    o = (lb - 1) // Wd if lb > 0 else 0
    parts = {}
    cell = None
    for d in range(o, -1, -1):
        w = walker(mesh, d)
        # a copy between cards waits on both cards' current streams: the
        # walk streams of both, never a card's default stream, which the
        # next DP's strip copies hold (gotoh_mesh.schedule)
        if d == o:
            with on(walker(mesh, 0)), on(w):
                cell = torch.cat([
                    torch.tensor([la, lb], dtype=torch.int32).to(w.device),
                    st.to(w.device, torch.int32)])
        with on(w):
            steps, n, end = tb.walk_band(bands[d]["dec"][None], cell,
                                         d * Wd, max_steps)
            parts[d] = (steps, n)
        if d:
            nxt = walker(mesh, d - 1)
            with on(nxt), on(w):
                cell = end[0].to(nxt.device, non_blocking=True)
    out = []
    for d in range(o + 1):
        steps, n = parts[d]
        with on(walker(mesh, d)):
            k = int(n.cpu()[0])
            out.append(steps[0, :k].cpu().numpy())
    return np.concatenate(out), o, 2 * (o + 1)


class LongDP:
    """One column-sharded DP queued on a mesh (LongQueue.submit): its
    bands, score and end state until it is walked, then ``result``: its
    steps on the host (int8, forward order) and its score, fetched in
    ``fetches`` transfers; ``slot`` the queue's buffers it holds."""

    def __init__(self, shards, bands, score, st, la, lb, max_steps, slot):
        self.bands, self.score, self.st = bands, score, st
        self.la, self.lb, self.max_steps = la, lb, max_steps
        self.slot = slot
        # the bands' last work on each shard's own stream
        self.done = [event(sh) for sh in shards]
        self.result = None
        self.fetches = 0


class LongQueue:
    """Column-sharded DPs queued ahead of their walks, in waves that the
    cards hold: before a DP's bands are queued, the oldest queued DPs are
    walked (walk_bands; their bands freed) while INFLIGHT are queued or
    while a card cannot hold the new DP's bands beside what it holds
    (long_shortfall); where none is queued and a card still cannot,
    check_long_fits raises the named MemoryError.  The walks run on the
    cards' walk streams, beside the bands of the DPs queued after them.
    Each DP's decisions and match rings lie in buffers the queue keeps
    from DP to DP, one a band and slot (INFLIGHT slots), grown by at
    least an eighth at a time (``buffer``): DPs of unequal sizes
    allocated and freed in turn left a card's allocator with its large
    segments split, tens of GB free and none of them one DP's decisions
    (torch.OutOfMemoryError at KHV's ~295 kb, PERF.md).  Spans:
    ``mesh.bands`` the host's queueing of a DP's operands, sources and
    launches, ``mesh.walk`` a walk from its first band's launch to its
    steps on the host (after the DP's forward has finished).  stats (the
    engine's, or a dict) counts ``walk_handoffs`` (band crossings)."""

    # DPs whose bands are held at once: one walked while the next one's
    # bands run
    INFLIGHT = 2

    def __init__(self, mesh: Mesh, stats: Optional[dict] = None):
        self.mesh = mesh
        self.stats = {} if stats is None else stats
        self.queued = []
        self.buffers = {}           # (slot, band) -> uint8 tensor
        if any(sh.stream is not None for sh in mesh.shards):
            # an earlier queue's buffers, freed with it, back to the
            # cards whole before this one's are made
            torch.cuda.empty_cache()

    def buffer(self, slot: int, d: int, nbytes: int):
        """Band d's buffer of the slot, of at least nbytes on its card:
        the one kept, or a new one an eighth (rounded to a power of two)
        larger than asked where that is short."""
        buf = self.buffers.get((slot, d))
        if buf is None or buf.numel() < nbytes:
            self.buffers.pop((slot, d), None)
            del buf
            step = 1 << max(0, nbytes.bit_length() - 4)
            with on(self.mesh.shards[d]):
                buf = torch.empty(-(-nbytes // step) * step + step,
                                  dtype=torch.uint8,
                                  device=self.mesh.shards[d].device)
            self.buffers[(slot, d)] = buf
        return buf

    def _more(self, slot: int):
        """held(d, nbytes) of long_shortfall for the slot's buffers."""
        def more(d, nbytes):
            buf = self.buffers.get((slot, d))
            have = 0 if buf is None else buf.numel()
            if have >= nbytes:
                return 0
            step = 1 << max(0, nbytes.bit_length() - 4)
            return -(-nbytes // step) * step + step - have
        return more

    def submit(self, lhs, rhs, pc, pr, la: int, lb: int, eps: float,
               bonus=None, rows: Optional[int] = None,
               what: str = "merge") -> LongDP:
        """Queue one DP (long_operands' inputs) after walking
        what must go first; returns its LongDP.  rows: a launch's, by
        default gotoh_mesh.block_rows of the DP's bands."""
        shards = _one_process(self.mesh)
        L1p, W = lhs.shape[0], rhs.shape[0]
        if rows is None:
            alone = gotoh_mesh.alone(shards)
            rows = gotoh_mesh.block_rows(
                gotoh_mesh.band_width(W, len(shards), alone), alone)

        def slot():
            used = {dp.slot for dp in self.queued}
            return min(set(range(self.INFLIGHT)) - used)
        while self.queued and (
                len(self.queued) >= self.INFLIGHT or long_shortfall(
                    self.mesh, L1p, W, rows, self._more(slot()))):
            self.walk(self.queued[0])
        k = slot()
        check_long_fits(self.mesh, L1p, W, rows, what, self._more(k))
        with span("mesh.bands"):
            sources, prep, Wp = long_operands(self.mesh, lhs, rhs, pc, pr,
                                              la, lb, eps, bonus)
            bands, score, st = gotoh_mesh.forward(
                shards, sources, prep, la, lb, rows,
                alloc=lambda d, n: self.buffer(k, d, n))
            dp = LongDP(shards, bands, score, st, la, lb, L1p + Wp + 2, k)
        self.queued.append(dp)
        return dp

    def walk(self, dp: LongDP):
        """dp's (steps, score) on the host, walked where it is not yet."""
        if dp.result is None:
            for ev in dp.done:
                if ev is not None:
                    ev.synchronize()
            with span("mesh.walk"):
                steps, crossed, fetches = walk_bands(
                    self.mesh, dp.bands, dp.la, dp.lb, dp.st, dp.max_steps)
                # on the walk stream: the first shard's own holds the next
                # DP's bands
                with on(walker(self.mesh, 0)):
                    score = float(dp.score.cpu()[0])
            dp.result, dp.fetches = (steps, score), fetches + 1
            dp.bands = dp.score = dp.st = None
            self.queued.remove(dp)
            self.stats["walk_handoffs"] = \
                self.stats.get("walk_handoffs", 0) + crossed
        return dp.result
