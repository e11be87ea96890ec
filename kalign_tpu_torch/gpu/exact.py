"""Bit-exact device DP of the "gpu" engine.

Counterpart of kalign_tpu/tpu/exact.py.  Reproduces the reference
Hirschberg meet-in-the-middle alignment (aln_controller.c:21-436,
aln_seqseq.c, aln_seqprofile.c, aln_profileprofile.c) with the O(L^2)
sweep work on the card:

  * Every recursion depth packs its (row-disjoint) forward/backward
    windows into "segmented" anti-diagonal wavefront grids, swept by one
    launch of csrc/exact_sweep.cu (gpu/exact_sweep.py; its plain PyTorch
    version on the CPU).  Cell (i, j) depends on (i-1, j-1), (i-1, j)
    and (i, j-1) only, and the wavefront computes each cell with the
    same scalar float operation order as the reference row sweep, so the
    produced states are bit-identical.
  * The meetup combine (aln_seqseq.c:241-419) runs on the same device,
    for every window of a depth at once, in exact float32 (one
    elementwise operation at a time, as the reference orders them); the
    margin/flip bookkeeping and the recursion control run on the host,
    a depth's windows as arrays (``Wins``), and a depth's launches queue
    back to back with one fetch of its winners at the end.
  * A launch's plan carries per-row flags, bounds, seeds and addends
    built on the host; the dense match and bonus rows and the column
    addends are gathered on the device from small per-problem tables
    (``Operands``) uploaded once per hook call.

The module is driven through the native runtime's DP hooks
(native.set_*_hook): the C++ runtime keeps orchestrating profiles,
consistency tables, distance scaling and refinement, and calls back
here for every full-path alignment.  A callback never runs the native DP
in place of a sweep: a failed build or launch makes it return nonzero,
which stops the alignment, and the engine raises with ``last_error``.

How windows pack into grids (the VR budget, grids per launch) changes
no bit: each window's cells keep their own float order.
"""

import ctypes
import time

import numpy as np
import torch

from kalign_tpu_torch import native
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.gpu import exact_sweep

NEG = np.float32(-3.4028234663852886e38)  # -FLT_MAX, as the reference uses

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)

# match and bonus cells a launch's plan may hold (grids x rows x columns;
# 0.68 GB of float32 match and bonus rows): bounds the grids per launch
LAUNCH_CELLS = 64 * 4096 * 324
# the VR budget of the consistency pre-pass, by device type: how many
# virtual rows a grid may take so that the windows of several residue
# pairs share a grid (ExactPairBatch).  On the card a grid's steps follow
# its tallest band, not its height, so short grids, many to a launch,
# fill the card (PERF.md §6 gives the settings measured)
PACK_BUDGET = {"cuda": 256, "cpu": 0}


def pack_budget(device) -> int:
    return PACK_BUDGET[torch.device(device).type]


class Sweeper:
    """Runs stacked plans through the sweep on one device and counts
    what it ran: launches, grids and wavefront steps (per launch, the
    steps of its longest block: on the card the band-local schedule's,
    on the CPU the reference schedule's that the plain version runs),
    and the host's seconds spent enqueueing device work (``enqueue_s``:
    gathers, uploads, sweeps, meets) and waiting on fetches
    (``fetch_s``)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.launches = 0
        self.grids = 0
        self.steps = 0
        self.enqueue_s = 0.0
        self.fetch_s = 0.0

    def run(self, plans, key, live):
        """plans: {name: [G, ...]} (exact_sweep.PLAN_KEYS), numpy arrays
        or tensors on this device; key = (VR, C, Wmax, use_chain); live =
        (windows, columns) the caller reads.  Returns out [G, windows,
        columns, 3] on this device.  On the card the kernel's schedule is
        computed here from the plan's numpy rows and goes up with them."""
        VR, C, Wmax, chain = key
        if self.device.type == "cuda":
            lp = exact_sweep.launch_plan(VR)
            lag, span = exact_sweep.schedule(plans, live[1],
                                             lp.threads * lp.rows)
            plans = dict(plans, lag=lag, span=span)
            steps = exact_sweep.steps_run(span)
        else:
            steps = exact_sweep.live_steps(VR, C, live[1])
        t0 = time.perf_counter()
        t = upload(plans, self.device)
        out = exact_sweep.sweep(t, VR, C, Wmax, chain, live)
        self.enqueue_s += time.perf_counter() - t0
        self.launches += 1
        self.grids += int(plans["seedA"].shape[0])
        self.steps += steps
        return out


def on_device(x, device):
    """A numpy array or a tensor as a tensor on device."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def upload(arrays, device):
    """{name: numpy array or tensor} as tensors on device, the numpy
    arrays in one copy: their bytes end to end (each at a multiple of 8)
    in one buffer, viewed back on the device."""
    host = {k: np.ascontiguousarray(v) for k, v in arrays.items()
            if not torch.is_tensor(v)}
    out = {k: v.to(device) for k, v in arrays.items() if torch.is_tensor(v)}
    offs, n = {}, 0
    for k, v in host.items():
        offs[k] = n
        n += -(-v.nbytes // 8) * 8
    # page-locked on the card's side, so the copy is one DMA
    pinned = torch.device(device).type == "cuda"
    hbuf = torch.empty(n, dtype=torch.uint8, pin_memory=pinned)
    buf = hbuf.numpy()
    for k, v in host.items():
        buf[offs[k]:offs[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    dev = hbuf.to(device, non_blocking=pinned)
    for k, v in host.items():
        dt = torch.from_numpy(v[:0].reshape(-1)).dtype
        out[k] = dev[offs[k]:offs[k] + v.nbytes].view(dt).view(v.shape)
    return out


# --------------------------------------------------------------------
# host side: the recursions' windows, a depth at a time, as arrays
# --------------------------------------------------------------------

def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


# seeds (A, GA, GB) of a child window's init row
_ZNN = (0.0, NEG, NEG)
_NZN = (NEG, 0.0, NEG)
_NNZ = (NEG, NEG, 0.0)
_NONE = (NEG, NEG, NEG)
# the continuation table of aln_controller.c:194-436 by transition tr (the
# meetup's 1, 2, 3, 5, 6, 7): the left child ends at row mid + L_EA[tr]
# and column c + L_EB[tr] with backward seeds L_BS[tr]; the right child
# starts at row mid + R_SA[tr] and column c + R_SB[tr] with forward seeds
# R_FS[tr]; the raw path gets path[mid] = c (W_MID) and path[mid + 1] =
# c + 1 (W_MID1)
L_EA = np.array([0, -1, -1, -1, 0, 0, -1, -1], np.int64)
L_EB = np.array([0, -1, -1, -1, 0, -1, 0, 0], np.int64)
R_SA = np.array([0, 1, 0, 1, 0, 1, 1, 1], np.int64)
R_SB = np.array([0, 1, 1, 0, 0, 1, 0, 1], np.int64)
L_BS = np.array([_NONE, _ZNN, _ZNN, _ZNN, _NONE, _NZN, _NNZ, _NNZ],
                np.float32)
R_FS = np.array([_NONE, _ZNN, _NZN, _NNZ, _NONE, _ZNN, _NNZ, _ZNN],
                np.float32)
W_MID = np.array([0, 1, 1, 1, 0, 0, 0, 0], bool)
W_MID1 = np.array([0, 1, 0, 0, 0, 1, 0, 1], bool)
# the meetup's offer order per column: transitions of S[:, 0..5]
_TRANS = np.array([1, 2, 3, 5, 6, 7], np.int64)
# a node's place in the recursion tree: its left/right turns from the
# top, left-aligned in KEY_BITS bits; (key, depth) sorts in DFS preorder
# (a window halves its rows, so depths stay below log2(la) + 2)
KEY_BITS = 62


class Wins:
    """Windows of a recursion depth (aln_controller.c window state) as
    arrays: problem p, rows [sa, ea), columns [sb, eb), forward and
    backward seeds fs / bs [n, 3] (A, GA, GB), and the node's place in
    the recursion tree (key, depth), which orders the margins as the
    reference's recursion meets them."""
    FIELDS = ("p", "sa", "ea", "sb", "eb", "fs", "bs", "key", "depth")
    __slots__ = FIELDS

    def __init__(self, p, sa, ea, sb, eb, fs, bs, key, depth):
        self.p, self.sa, self.ea, self.sb, self.eb = p, sa, ea, sb, eb
        self.fs, self.bs, self.key, self.depth = fs, bs, key, depth

    @classmethod
    def of(cls, rows):
        """From (p, sa, ea, sb, eb, fs, bs) tuples, each a top node."""
        n = len(rows)
        ints = [np.array([r[k] for r in rows], np.int64) for k in range(5)]
        seeds = [np.array([r[k] for r in rows], np.float32).reshape(n, 3)
                 for k in (5, 6)]
        z = np.zeros(n, np.int64)
        return cls(*ints, *seeds, z, z.copy())

    @classmethod
    def tops(cls, la, lb):
        """The top window of each problem p: rows [0, la[p]), columns
        [0, lb[p]), seeds (0, -FLT_MAX, -FLT_MAX) both ways."""
        return cls.of([(p, 0, a, 0, b, _ZNN, _ZNN)
                       for p, (a, b) in enumerate(zip(la, lb))])

    def __len__(self):
        return len(self.sa)

    @property
    def mid(self):
        return self.sa + (self.ea - self.sa) // 2

    def take(self, idx):
        return Wins(*(getattr(self, f)[idx] for f in self.FIELDS))

    def live(self):
        return self.take((self.sa < self.ea) & (self.sb < self.eb))

    @classmethod
    def cat(cls, parts):
        return cls(*(np.concatenate([getattr(w, f) for w in parts])
                     for f in cls.FIELDS))


class Operands:
    """The operands of a set of problems, flat: problem p's rows at
    rowoff[p] .. rowoff[p] + la[p] of the per-row arrays (gap addends,
    profile counts, and ``rowtab``, the 23 match values of each row by
    column residue: subm[s1[i]] - soff, or the row's profile
    substitution scores), its column residues in bcodes[p, :lb[p]], its
    consistency bonus as the runtime's flat array (row i, column j at
    bonus[boff[p] + i * bstride[p] + j]); its meet addends per column at
    coloff[p] and per row at roff[p] (la + 2 rows: t3 = r27[mid + 1], t7
    = r27[mid], t6 = r29 at a terminal edge, else r28, at mid + 1); its
    column addends packed per sweep shape (colpacks).  The match and
    bonus rows of the sweep's grid coordinates are built from these on
    the sweep's device (``on``).  ``kind`` "pairs" or "merge" and
    ``mode`` per problem name the launches (chip_smoke.py)."""

    def __init__(self, kind, la, lb, mode, VR, Cpad, Wmax, rowtab, bcodes,
                 bonus, rows, p1cnt, meet_cols, meet_rows, cols, p2sub,
                 colof=None):
        self.kind = kind
        self.la = np.asarray(la, np.int64)
        self.lb = np.asarray(lb, np.int64)
        self.mode = np.asarray(mode, np.int64)
        self.chain = self.mode == 2
        self.VR, self.Cpad, self.Wmax = VR, Cpad, Wmax
        self.rowoff = np.concatenate([[0], np.cumsum(self.la)[:-1]])
        self.coloff = np.concatenate([[0], np.cumsum(self.lb + 1)[:-1]])
        self.roff = np.concatenate([[0], np.cumsum(self.la + 2)[:-1]])
        self.rowtab, self.bcodes = rowtab, bcodes
        self.bonus = bonus          # None, or (flat, boff, bstride, has)
        (self.gb_ext, self.gb_open, self.gb_tg, self.dgbF,
         self.dgbB) = rows
        self.p1cnt = p1cnt
        self.t2v, self.t5v = meet_cols
        self.r27, self.r28, self.r29 = meet_rows
        # column addends: (forward, backward) arrays, and p2sub's or None,
        # of problem p at index colof[p]
        self._cols, self._p2sub = cols, p2sub
        self.colof = (np.arange(len(self.la)) if colof is None
                      else np.asarray(colof, np.int64))
        self.nrows = int(self.la.sum())
        self.width = int(self.lb.max()) + 1
        self._dev = {}

    def on(self, name, device):
        """A store on device, built once: "match" / "bonus" ([2 nrows +
        1, width]: the forward rows, then the backward rows, then a zero
        row), "p1cnt" (the rows, then a zero row), "t2v", "t5v"."""
        key = (name, str(device))
        if key not in self._dev:
            if name in ("match", "bonus"):
                self._dev[key] = self._grid_rows(name, device)
            elif name == "p1cnt":
                self._dev[key] = on_device(np.concatenate(
                    [self.p1cnt, np.zeros((1, NSUB), np.float32)]), device)
            else:
                self._dev[key] = on_device(getattr(self, name), device)
        return self._dev[key]

    # rows per step of the stores' build (bounds its temporaries)
    _BUILD_ROWS = 1 << 15

    def _grid_rows(self, name, device):
        """The match or bonus rows in grid coordinates: forward, row i of
        problem p, column q holds core[i, q - 1] for 1 <= q <= lb (match;
        the bonus: bonus[i, q] for q <= lb), backward the same reversed at
        the problem's width (match: core[i, lb - q] for 1 <= q <= lb;
        bonus: bonus[i, lb - q] for q <= lb), zero elsewhere and in the
        problems without a match (profile x profile) or a bonus: the
        dense [la, lb + 1] matrices of the reference's plans, gathered
        here from the small tables, value for value."""
        W, R = self.width, self.nrows
        out = torch.zeros((2 * R + 1, W), dtype=torch.float32, device=device)
        prob = np.repeat(np.arange(len(self.la)), self.la)
        row = np.arange(R) - self.rowoff[prob]
        q = torch.arange(W, device=device)
        if name == "match":
            tab = on_device(self.rowtab, device)
            codes = on_device(self.bcodes, device)
            on = ~self.chain[prob]
        else:
            flat, boff, bstride, has = self.bonus
            flat = on_device(flat, device)
            on = has[prob]
        for lo in range(0, R, self._BUILD_ROWS):
            hi = min(lo + self._BUILD_ROWS, R)
            p = on_device(prob[lo:hi], device)
            lb = on_device(self.lb[prob[lo:hi]], device)[:, None]
            live = on_device(on[lo:hi], device)[:, None]
            for d in (0, 1):
                if name == "match":
                    col = q - 1 if d == 0 else lb - q
                    ok = live & (q >= 1) & (q <= lb)
                    res = codes[p[:, None], col.clamp(0, codes.shape[1] - 1)]
                    val = tab[lo:hi].gather(1, res.long())
                else:
                    col = q if d == 0 else lb - q
                    ok = live & (q <= lb) & (col >= 0)
                    base = on_device(boff[prob[lo:hi]] + row[lo:hi]
                                     * bstride[prob[lo:hi]], device)
                    at = (base[:, None] + col).clamp(0, flat.shape[0] - 1)
                    val = flat[at]
                out[d * R + lo:d * R + hi] = torch.where(
                    ok, val, torch.zeros_like(val))
        return out

    @classmethod
    def of_aligners(cls, alns):
        """The operands of ExactAligners that share (VR, Cpad, Wmax)."""
        a0 = alns[0]
        cat = lambda f: np.concatenate([getattr(a, f) for a in alns])
        chain = [a for a in alns if a.use_chain]
        codes = np.zeros((len(alns), max(max(a.lb for a in alns), 1)),
                         np.int64)
        for k, a in enumerate(alns):
            if a.bcodes is not None:
                codes[k, :a.lb] = a.bcodes
        bonus = None
        if any(a.bonus is not None for a in alns):
            vecs = [a.bonus[0] if a.bonus is not None
                    else np.zeros(0, np.float32) for a in alns]
            boff = np.concatenate([[0], np.cumsum([len(v) for v in vecs])
                                   [:-1]]).astype(np.int64)
            bonus = (np.concatenate(vecs), boff,
                     np.array([a.bonus[1] if a.bonus is not None else 0
                               for a in alns], np.int64),
                     np.array([a.bonus is not None for a in alns]))
        return cls(
            "merge", [a.la for a in alns], [a.lb for a in alns],
            [a.mode for a in alns], a0.VR, a0.Cpad, a0.Wmax,
            cat("rowtab"), codes, bonus,
            tuple(cat(f) for f in ("gb_ext", "gb_open", "gb_tg", "dgbF",
                                   "dgbB")),
            cat("p1cnt_g") if chain else None,
            (cat("t2v"), cat("t5v")),
            tuple(cat(f) for f in ("r27", "r28", "r29")),
            [(a.colsF, a.colsB) for a in alns],
            [(a.p2subF, a.p2subB_r) if a.use_chain else None
             for a in alns])

    def _colpack(self, q):
        """Column set q's addends in the sweep's layout: each array
        zero-extended to Cpad + 1 columns, reversed and padded with VR
        zeros on each side; (forward, backward) dicts of plan keys."""
        VR, C = self.VR, self.Cpad

        def pack(a):
            full = np.zeros((C + 1,) + a.shape[1:], np.float32)
            full[:a.shape[0]] = a
            pad = np.zeros((VR,) + a.shape[1:], np.float32)
            return np.concatenate([pad, full[::-1], pad])
        out = []
        for d in (0, 1):
            g = dict(zip(exact_sweep.COL_F32,
                         (pack(a) for a in self._cols[q][d])))
            p2 = self._p2sub[q]
            g["p2sub_p"] = pack(p2[d] if p2 is not None
                                else np.zeros((1, NSUB), np.float32))
            out.append(g)
        return out

    def colpacks(self, ps, device):
        """The column packs of grids 2c (forward) and 2c + 1 (backward)
        of chunks of problems ps, on device (every column set's packs go
        up once, in one copy)."""
        key = ("packs", str(device))
        if key not in self._dev:
            packs = [self._colpack(q) for q in range(len(self._cols))]
            self._dev[key] = upload(
                {k: np.stack([[pk[d][k] for d in (0, 1)] for pk in packs])
                 for k in exact_sweep.COL_F32 + ("p2sub_p",)}, device)
        st = self._dev[key]
        idx = upload({"i": self.colof[ps]}, device)["i"]
        return {k: v.index_select(0, idx).flatten(0, 1)
                for k, v in st.items()}


NSUB = exact_sweep.NSUB


def _chunks(w, VR, Wmax, by_problem):
    """Pack windows, in order, into chunks whose forward and backward
    bands (rows + 1 each) fit in VR virtual rows, of at most Wmax windows
    (one problem's only with by_problem).  Returns (chunk, slot) per
    window and the number of chunks."""
    mid = w.mid
    rf = (mid - w.sa + 1).tolist()
    rb = (w.ea - mid + 1).tolist()
    p = w.p.tolist()
    n = len(rf)
    chunk, slot = [0] * n, [0] * n
    c, sf, sb, k, cur = -1, 0, 0, 0, None
    for i in range(n):
        if (c < 0 or sf + rf[i] > VR or sb + rb[i] > VR or k >= Wmax
                or (by_problem and p[i] != cur)):
            c, sf, sb, k, cur = c + 1, 0, 0, 0, p[i]
        chunk[i], slot[i] = c, k
        k += 1
        sf += rf[i]
        sb += rb[i]
    return np.array(chunk, np.int64), np.array(slot, np.int64), c + 1


def _plans(ops, w, chunk, slot, nchunks, width, device, sweeper=None):
    """The stacked plans of the chunks (grid 2c forward, 2c + 1 backward,
    exact_sweep.PLAN_KEYS) with match and bonus ``width`` columns wide:
    the per-row flags, bounds, seeds and addends built here, the match,
    bonus and profile-count rows gathered on device from the operands'
    stores (uploaded once), the column packs stacked there.
    Each window takes a band of rows per grid: its init row (seeds), then
    its rows (forward: sa .. mid - 1; backward: ea - 1 .. mid, in column-
    reversed coordinates q = lb - j); its last row is final and writes its
    slot.  Every chunk of a launch holds one problem's windows, or
    windows of problems that share their column addends (the pairs).
    The device part's host seconds add to sweeper.enqueue_s."""
    VR, Wmax = ops.VR, ops.Wmax
    G = 2 * nchunks
    rows = G * VR
    f32, i32 = np.float32, np.int32
    g = dict(
        is_init=np.zeros(rows, bool), is_final=np.zeros(rows, bool),
        active=np.zeros(rows, bool), init_tg=np.zeros(rows, bool),
        start_tg=np.zeros(rows, bool), end_tg=np.zeros(rows, bool),
        startq=np.zeros(rows, i32), endq=np.full(rows, -1, i32),
        win_slot=np.full(rows, Wmax, i32),
        **{k: np.zeros(rows, f32) for k in exact_sweep.ROW_F32})
    # each row's source in the stores: match / bonus rows (forward, then
    # backward), profile counts; the stores' last row is zero
    msrc = np.full(rows, 2 * ops.nrows, np.int64)
    psrc = np.full(rows, ops.nrows, np.int64)
    n = len(w)
    mid = w.mid
    lb = ops.lb[w.p]
    first = np.flatnonzero(np.r_[True, chunk[1:] != chunk[:-1]])
    for d in (0, 1):
        if d == 0:
            R, seeds = mid - w.sa, w.fs
            startq, endq = w.sb, w.eb
            init_tg, end_tg = w.sb == 0, w.eb == lb
        else:
            R, seeds = w.ea - mid, w.bs
            startq, endq = lb - w.eb, lb - w.sb
            init_tg, end_tg = w.eb == lb, w.sb == 0
        band = R + 1
        cum = np.cumsum(band) - band
        base = (2 * chunk + d) * VR + cum - np.repeat(cum[first],
                                                      np.diff(np.r_[first,
                                                                    n]))
        wi = np.repeat(np.arange(n), band)
        e = np.arange(int(band.sum())) - np.repeat(cum, band)
        flat = base[wi] + e
        g["active"][flat] = True
        g["startq"][flat] = startq[wi]
        g["endq"][flat] = endq[wi]
        g["init_tg"][flat] = init_tg[wi]
        g["start_tg"][flat] = init_tg[wi]
        g["end_tg"][flat] = end_tg[wi]
        g["is_init"][base] = True
        g["seedA"][base], g["seedGA"][base], g["seedGB"][base] = seeds.T
        g["is_final"][base + R] = True
        g["win_slot"][base + R] = slot
        proc = e > 0
        fp, wp, ep = flat[proc], wi[proc], e[proc]
        grow = w.sa[wp] + ep - 1 if d == 0 else w.ea[wp] - ep
        src = ops.rowoff[w.p[wp]] + grow
        g["gb_ext"][fp] = ops.gb_ext[src]
        g["gb_open"][fp] = ops.gb_open[src]
        g["gb_tg"][fp] = ops.gb_tg[src]
        g["dgb"][fp] = (ops.dgbF if d == 0 else ops.dgbB)[src]
        msrc[fp] = src + d * ops.nrows
        psrc[fp] = src
    out = {k: v.reshape(G, VR) for k, v in g.items()}
    t0 = time.perf_counter()
    src = upload({"match": msrc, "p1cnt": psrc}, device)

    def rows_of(name, idx, cols):
        store = ops.on(name, device)[:, :cols]
        return store.index_select(0, src[idx]).view(G, VR, cols)
    zeros = lambda c: torch.zeros((G, VR, c), dtype=torch.float32,
                                  device=device)
    out["match"] = rows_of("match", "match", width)
    out["bonus"] = (rows_of("bonus", "match", width)
                    if ops.bonus is not None else zeros(width))
    out["p1cnt"] = (rows_of("p1cnt", "p1cnt", NSUB)
                    if ops.p1cnt is not None else zeros(NSUB))
    out.update(ops.colpacks(w.p[first], device))
    if sweeper is not None:
        sweeper.enqueue_s += time.perf_counter() - t0
    return out


def _meets(ops, w, out, gF, gB, slot):
    """aln_*_meetup + finish_meet (kt_gotoh.cpp meet_rr / meet_pr /
    meet_pp) of every window at once, on out's device, in exact float32
    in the reference's operation order (one elementwise operation at a
    time; divisions by tensors, which round as IEEE division does), from
    its forward and backward final rows (out[gF, slot, j] and out[gB,
    slot, lb - j]).  Each window offers, per column j in [sb, eb), six
    candidates S[j, 0..5] in that order, then f3 and f6 at eb;
    MeetState::offer keeps a strict-> two-max over that sequence: the
    winner is its first maximum, the runner-up the first other position
    holding the largest remaining value.  Returns, on the device, the
    positions of the winner and the runner-up and whether each beat
    -FLT_MAX ([4, n]: i1, i2, has1, has2), and the margin max1 - max2
    (_decode reads them)."""
    dev = out.device
    f32 = torch.float32
    n = len(w)
    sb, eb = w.sb, w.eb
    nn = eb - sb
    lb = ops.lb[w.p]
    mid = w.mid
    r = ops.roff[w.p]
    t6 = lambda edge: np.where(edge, ops.r29[r + mid + 1],
                               ops.r28[r + mid + 1])
    up = upload({"I": np.stack([gF, gB, slot, sb, eb, lb, nn,
                                ops.coloff[w.p]]),
                 "T": np.stack([ops.r27[r + mid + 1], ops.r27[r + mid],
                                t6(sb == 0), t6(eb == lb)])}, dev)
    gF, gB, slot, sb, eb, lb, nn, co = up["I"]
    T = up["T"]
    t3, t7, t6_in, t6_end = T
    M = int(w.eb.sum() - w.sb.sum())
    wi = torch.repeat_interleave(torch.arange(n, device=dev), nn,
                                 output_size=M)
    loc = torch.arange(M, device=dev) - (torch.cumsum(nn, 0) - nn)[wi]
    j = sb[wi] + loc
    Fj = out[gF[wi], slot[wi], j]
    Bj = out[gB[wi], slot[wi], lb[wi] - j]
    Fe = out[gF, slot, eb]
    Be = out[gB, slot, lb - eb]
    full = lambda x, v: torch.full_like(x, v)
    middle = nn.to(f32) / full(t3, 2.0) + sb.to(f32)
    sub = torch.abs(middle[wi] - j.to(f32))
    sub = sub / full(sub, 1000.0)
    sub_e = torch.abs(middle - eb.to(f32))
    sub_e = sub_e / full(sub_e, 1000.0)
    fa, fga, fgb = Fj.unbind(1)
    ba, bga, bgb = Bj.unbind(1)
    t2v = ops.on("t2v", dev)[co[wi] + j]
    t5v = ops.on("t5v", dev)[co[wi] + j]
    S = torch.stack([(fa + ba) - sub,
                     ((fa + bga) + t2v) - sub,
                     ((fa + bgb) + t3[wi]) - sub,
                     ((fga + ba) + t5v) - sub,
                     ((fgb + bgb) + t6_in[wi]) - sub,
                     ((fgb + ba) + t7[wi]) - sub], 1)
    E = torch.stack([((Fe[:, 0] + Be[:, 2]) + t3) - sub_e,
                     ((Fe[:, 2] + Be[:, 2]) + t6_end) - sub_e], 1)
    # positions in each window's offer sequence
    posS = 6 * loc[:, None] + torch.arange(6, device=dev)
    posE = 6 * nn[:, None] + torch.arange(2, device=dev)
    none = torch.iinfo(torch.int64).max

    def two(S, E, skip):
        """(max, its first position) per window, position skip left
        out."""
        if skip is not None:
            S = torch.where(posS == skip[wi, None], -torch.inf, S)
            E = torch.where(posE == skip[:, None], -torch.inf, E)
        m = torch.full((n,), -torch.inf, dtype=f32, device=dev)
        m = m.scatter_reduce(0, wi, S.amax(1), "amax")
        m = torch.maximum(m, E.amax(1))
        at = torch.where(S == m[wi, None], posS, none).amin(1)
        i = torch.full((n,), none, dtype=torch.int64, device=dev)
        i = i.scatter_reduce(0, wi, at, "amin")
        i = torch.minimum(i, torch.where(E == m[:, None], posE,
                                         none).amin(1))
        return m, i
    m1, i1 = two(S, E, None)
    m2, i2 = two(S, E, i1)
    has1 = m1 > NEG
    has2 = has1 & (m2 > NEG)
    margin = torch.where(has2, m1 - m2, torch.zeros_like(m1))
    return torch.stack([i1, i2, has1.long(), has2.long()]), margin


def _decode(w, pos, margin):
    """The meets' (c, tr, c2, tr2, has2, margin) from the offer positions
    of the winner and the runner-up and their flags (pos [4, n]: i1, i2,
    has1, has2)."""
    i1, i2 = pos[0], pos[1]
    has1, has2 = pos[2].astype(bool), pos[3].astype(bool)
    sb, eb, nn = w.sb, w.eb, w.eb - w.sb

    def decode(k, ok):
        inner = ok & (k < 6 * nn)
        k = np.where(ok, k, 0)
        c = np.where(inner, sb + k // 6, eb)
        tr = np.where(inner, _TRANS[k % 6], np.where(k == 6 * nn, 3, 6))
        return np.where(ok, c, -1), np.where(ok, tr, -1)
    c, tr = decode(i1, has1)
    c2, tr2 = decode(i2, has2)
    return c, tr, c2, tr2, has2, margin


def _spawn(w, c, tr, path, at):
    """The children of every window and its raw-path writes
    (aln_controller.c:194-436): per window path[mid] = c, then path[mid +
    1] = c + 1 where its transition writes them (a later write to a
    position wins, as in the reference's order); children left then right
    of each window.  path holds the recursions' paths end to end, window
    i's at at[i].  Returns (the live children, the index of each one's
    parent in w)."""
    has = np.flatnonzero(tr > 0)
    w, c, tr = w.take(has), c[has], tr[has]
    mid = w.mid
    base = at[has] + mid
    idx = np.stack([base, base + 1], 1).ravel()
    val = np.stack([c, c + 1], 1).ravel()
    keep = np.stack([W_MID[tr], W_MID1[tr]], 1).ravel()
    idx, val = idx[keep], val[keep]
    _, last = np.unique(idx[::-1], return_index=True)
    last = len(idx) - 1 - last
    path[idx[last]] = val[last]
    d = w.depth + 1
    right = np.left_shift(np.int64(1), (KEY_BITS - d).astype(np.int64))
    L = Wins(w.p, w.sa, mid + L_EA[tr], w.sb, c + L_EB[tr], w.fs,
             L_BS[tr], w.key, d)
    R = Wins(w.p, mid + R_SA[tr], w.ea, c + R_SB[tr], w.eb, R_FS[tr],
             w.bs, w.key | right, d)
    both = Wins(*(np.stack([getattr(L, f), getattr(R, f)], 1).reshape(
        (-1,) + getattr(L, f).shape[1:]) for f in Wins.FIELDS))
    alive = (both.sa < both.ea) & (both.sb < both.eb)
    return both.take(alive), np.repeat(has, 2)[alive]


def _margin_sums(nprob, rec):
    """Per problem (margin_sum, margin_count, margins in the reference's
    finish_meet order, DFS preorder) from the depths' records (p, key,
    depth, margin) of the windows with a runner-up; the sum in float32,
    one add at a time from 0."""
    if rec:
        p, key, depth, m = (np.concatenate(x) for x in zip(*rec))
    else:
        p = key = depth = np.zeros(0, np.int64)
        m = np.zeros(0, np.float32)
    order = np.lexsort((depth, key, p))
    p, m = p[order], m[order]
    out = []
    for q in range(nprob):
        mq = m[p == q]
        acc = np.add.accumulate(np.r_[np.float32(0.0), mq].astype(
            np.float32))
        out.append((np.float32(acc[-1]), len(mq), list(mq)))
    return out


def _sweep_depth(ops, w, sweeper, by_problem):
    """One recursion step of every window in w: chunked (_chunks), the
    chunks of one operand form (chain or not) split evenly over as few
    launches as LAUNCH_CELLS allows, swept, met.  Returns _meets' arrays
    in w's order."""
    chunk, slot, nchunks = _chunks(w, ops.VR, ops.Wmax, by_problem)
    first = np.flatnonzero(np.r_[True, chunk[1:] != chunk[:-1]])
    chain_of = ops.chain[w.p[first]]
    sels, pos, margins = [], [], []
    # launches: the chunks of one form, the form first met first
    forms = chain_of[np.sort(np.unique(chain_of, return_index=True)[1])]
    most = max(1, LAUNCH_CELLS // (2 * ops.VR * ops.width))
    for cs in (np.flatnonzero(chain_of == ch) for ch in forms):
        n = -(-len(cs) // most)               # launches of this form
        per = -(-len(cs) // n)                # chunks a launch, balanced
        for lo in range(0, len(cs), per):
            group = cs[lo:lo + per]
            sel = np.flatnonzero(np.isin(chunk, group))
            ws = w.take(sel)
            remap = np.full(nchunks, -1, np.int64)
            remap[group] = np.arange(len(group))
            ch = remap[chunk[sel]]
            width = int(ops.lb[ws.p].max()) + 1
            plans = _plans(ops, ws, ch, slot[sel], len(group), width,
                           sweeper.device, sweeper)
            nslot = int(slot[sel].max()) + 1
            out = sweeper.run(plans, (ops.VR, ops.Cpad, ops.Wmax,
                                      bool(chain_of[group[0]])),
                              (nslot, width))
            t0 = time.perf_counter()
            p_, m_ = _meets(ops, ws, out, 2 * ch, 2 * ch + 1, slot[sel])
            sweeper.enqueue_s += time.perf_counter() - t0
            sels.append(sel)
            pos.append(p_)
            margins.append(m_)
    # one fetch for the depth: the card runs a launch while the host
    # builds the next
    sel = np.concatenate(sels)
    t0 = time.perf_counter()
    pos, margins = torch.cat(pos, 1).cpu().numpy(), \
        torch.cat(margins).cpu().numpy()
    sweeper.fetch_s += time.perf_counter() - t0
    got = _decode(w.take(sel), pos, margins)
    res = [np.empty_like(g) for g in got]
    for r_, g_ in zip(res, got):
        r_[sel] = g_
    return res


class ExactAligner:
    """One merge's operands (all three modes: residues x residues,
    profile x residues, profile x profile) in the sweep's grid
    coordinates, and its meet-in-the-middle recursion (``run``).  All
    float scalar work (meetup, margins, flips) is numpy float32 in the
    reference's operation order."""

    def __init__(self, mode, seq1, seq2, prof1, prof2, len_a, len_b, sip,
                 subm, gpo, gpe, tgpe, soff, bonus,
                 flip_threshold=0.0, flip_trial=0, flip_stride=1,
                 bstride=None, sweeper=None):
        self.sweeper = Sweeper() if sweeper is None else sweeper
        self.mode = mode
        self.la, self.lb = len_a, len_b
        self.flip_threshold = np.float32(flip_threshold)
        self.flip_trial = int(flip_trial)
        self.flip_stride = max(int(flip_stride), 1)
        self.flip_counter = 0

        la, lb = len_a, len_b
        gpo, gpe, tgpe = np.float32(gpo), np.float32(gpe), np.float32(tgpe)
        soff = np.float32(soff)
        self.gpo, self.gpe, self.tgpe = gpo, gpe, tgpe

        C = lb  # grid columns 0..C
        self.C = C
        self.Cpad = _pow2(C + 1) - 1   # kernel C (cols 0..Cpad)
        self.VR = _pow2(max((la + 1) // 2 + 2, 8))
        self.Wmax = self.VR
        self.use_chain = mode == 2

        z = np.zeros
        f32 = np.float32
        # ---- match: per row its 23 values by column residue (the
        # reference's core[i, j] = rowtab[i, bcodes[j]]); bonus ----
        if mode == 0:
            s1 = np.frombuffer(seq1, dtype=np.uint8, count=la) \
                if isinstance(seq1, bytes) else seq1
            se = (subm.astype(f32) - soff).astype(f32)
            self.rowtab = se[s1]
            self.bcodes = seq2
        elif mode == 1:
            P1 = prof1.reshape(la + 2, 64)
            self.rowtab = P1[1:la + 1, 32:55]
            self.bcodes = seq2
        else:
            P1 = prof1.reshape(la + 2, 64)
            P2 = prof2.reshape(lb + 2, 64)
            self.rowtab = z((la, 23), f32)     # no match in chain mode
            self.bcodes = None
        # the runtime's bonus array: row i, column j (j <= lb) at
        # i * stride + j
        self.bonus = None
        if bonus is not None:
            stride = lb if bstride is None else int(bstride)
            self.bonus = (bonus[:(la - 1) * stride + lb + 1] if la else
                          bonus[:0], stride)

        # ---- per-row addends (global row i) ----
        if mode == 0:
            self.gb_ext = np.full(la, -gpe, f32)
            self.gb_open = np.full(la, -gpo, f32)
            self.gb_tg = np.full(la, -tgpe, f32)
            self.dgbF = np.full(la, -gpo, f32)
            self.dgbB = np.full(la, -gpo, f32)
        else:
            self.gb_ext = P1[1:la + 1, 28].copy()
            self.gb_open = P1[1:la + 1, 27].copy()
            self.gb_tg = P1[1:la + 1, 29].copy()
            self.dgbF = P1[0:la, 27].copy()
            self.dgbB = P1[2:la + 2, 27].copy()
        # pp match chain rows
        if mode == 2:
            self.p1cnt_g = P1[1:la + 1, 0:23].copy()
            p2F = z((C + 1, 23), f32)
            p2F[:lb + 1] = P2[0:lb + 1, 32:55]
            p2B = z((C + 1, 23), f32)
            p2B[:lb + 1] = P2[1:lb + 2, 32:55]
            self.p2subF = p2F
            self.p2subB_r = p2B[::-1].copy()
        else:
            self.p1cnt_g = z((la, 23), f32)
            self.p2subF = self.p2subB_r = None

        # ---- per-column addends in grid coordinates ----
        jj = np.arange(C + 1)
        if mode == 0:
            caF = (np.full(C + 1, -gpe, f32), np.full(C + 1, -gpo, f32),
                   np.full(C + 1, -tgpe, f32), np.full(C + 1, -gpo, f32))
            caB = caF
        elif mode == 1:
            op = f32(gpo * np.float32(sip))
            ex = f32(gpe * np.float32(sip))
            tx = f32(tgpe * np.float32(sip))
            caF = (np.full(C + 1, -ex, f32), np.full(C + 1, -op, f32),
                   np.full(C + 1, -tx, f32), np.full(C + 1, -op, f32))
            caB = caF
        else:
            gaF_ext = P2[jj, 28].astype(f32)
            gaF_open = P2[jj, 27].astype(f32)
            gaF_tg = P2[jj, 29].astype(f32)
            dgaF = z(C + 1, f32)
            dgaF[1:] = P2[jj[1:] - 1, 27]
            jb1 = np.minimum(jj + 1, lb + 1)
            jb2 = np.minimum(jj + 2, lb + 1)
            gaB_ext = P2[jb1, 28].astype(f32)
            gaB_open = P2[jb1, 27].astype(f32)
            gaB_tg = P2[jb1, 29].astype(f32)
            dgaB = P2[jb2, 27].astype(f32)
            caF = (gaF_ext, gaF_open, gaF_tg, dgaF)
            caB = (gaB_ext, gaB_open, gaB_tg, dgaB)
        # backward arrays live in reversed grid coordinates q = lb - j
        self.colsF = caF
        self.colsB = tuple(a[::-1].copy() for a in caB)

        # meet transition addends: per column (t2, t5) and per row
        # (_trans_adds: t3 = r27[mid + 1], t7 = r27[mid], t6 = r29 at a
        # terminal edge else r28, at mid + 1)
        if mode == 0:
            self.t2v = np.full(C + 1, -gpo, f32)
            self.t5v = np.full(C + 1, -gpo, f32)
            self.r27 = np.full(la + 2, -gpo, f32)
            self.r28 = np.full(la + 2, -gpe, f32)
            self.r29 = np.full(la + 2, -tgpe, f32)
        else:
            if mode == 1:
                self.t2v = np.full(C + 1, -f32(gpo * np.float32(sip)), f32)
                self.t5v = np.full(C + 1, -f32(gpo * np.float32(sip)), f32)
            else:
                self.t2v = P2[np.minimum(jj + 1, lb + 1), 27].astype(f32)
                self.t5v = P2[jj, 27].astype(f32)
            self.r27 = P1[:, 27].astype(f32)
            self.r28 = P1[:, 28].astype(f32)
            self.r29 = P1[:, 29].astype(f32)

    def plans(self, windows, device="cpu"):
        """The stacked (forward, backward) plan of one chunk holding the
        windows (sa, ea, sb, eb, fs, bs) in order, at this aligner's grid
        shape, match and bonus lb + 1 columns wide."""
        w = Wins.of([(0,) + tuple(x) for x in windows])
        n = len(w)
        return _plans(Operands.of_aligners([self]), w,
                      np.zeros(n, np.int64), np.arange(n), 1, self.lb + 1,
                      torch.device(device))

    def run(self, path_out):
        """Full recursion; returns (margin_sum, margin_count, margins)."""
        if self.flip_threshold > 0.0 and self.flip_trial > 0:
            return run_flip_trials([self], [path_out])[0]
        ops = Operands.of_aligners([self])
        w = Wins.tops([self.la], [self.lb]).live()
        rec = []
        while len(w):
            c, tr, _, _, has2, margin = _sweep_depth(ops, w, self.sweeper,
                                                     True)
            rec.append((w.p[has2], w.key[has2], w.depth[has2],
                        margin[has2]))
            w, _ = _spawn(w, c, tr, path_out, np.zeros(len(w), np.int64))
        return _margin_sums(1, rec)[0]


# --------------------------------------------------------------------
# batched residues x residues problems (consistency pre-pass)
# --------------------------------------------------------------------

class ExactPairBatch:
    """All of the consistency pre-pass's N x K pairwise (residues x
    residues) Hirschberg recursions in lockstep: every depth packs the
    live windows of every problem into shared segmented-wavefront grids,
    as many chunks a launch as LAUNCH_CELLS allows.  Sharing one grid
    across problems is exact here because rr-mode column penalty addends are
    scalars (the same for every problem); per-window row data and edge
    flags come from each window's own problem."""

    def __init__(self, pairs, subm, gpo, gpe, tgpe, sweeper=None):
        self.sweeper = Sweeper() if sweeper is None else sweeper
        f32 = np.float32
        gpo, gpe, tgpe = f32(gpo), f32(gpe), f32(tgpe)
        se = subm.astype(f32)  # soff = 0 in the consistency pass
        la = [len(a) for a, _ in pairs]
        lb = [len(b) for _, b in pairs]
        # VR is both the grid height and the chunk-packing budget: size
        # it to hold SEVERAL problems' top-level windows (up to a cap) so
        # early recursion depths batch across problems too
        single = max((n + 1) // 2 + 2 for n in la)
        total = sum((n + 1) // 2 + 2 for n in la)
        budget = pack_budget(self.sweeper.device)
        self.VR = _pow2(max(8, single, min(total, budget)))
        self.C = max(lb)
        self.Cpad = _pow2(self.C + 1) - 1
        self.Wmax = self.VR
        # match: per row its 23 values by column residue (core[i, j] =
        # subm[s1[i], s2[j]])
        rowtab = np.concatenate([se[s1] for s1, _ in pairs]) if la else \
            np.zeros((0, 23), f32)
        codes = np.zeros((len(pairs), max(max(lb), 1)), np.int64)
        for k, (_, s2) in enumerate(pairs):
            codes[k, :len(s2)] = s2
        rows = sum(la)
        full = lambda n, v: np.full(n, v, f32)
        C = self.Cpad
        cols = (full(C + 1, -gpe), full(C + 1, -gpo), full(C + 1, -tgpe),
                full(C + 1, -gpo))
        ncol = sum(lb) + len(lb)
        nrow = rows + 2 * len(la)
        self.ops = Operands(
            "pairs", la, lb, [0] * len(pairs), self.VR, self.Cpad,
            self.Wmax, rowtab, codes, None,
            (full(rows, -gpe), full(rows, -gpo), full(rows, -tgpe),
             full(rows, -gpo), full(rows, -gpo)), None,
            (full(ncol, -gpo), full(ncol, -gpo)),
            (full(nrow, -gpo), full(nrow, -gpe), full(nrow, -tgpe)),
            [(cols, cols)], [None], colof=np.zeros(len(la), np.int64))

    def run(self, paths_out):
        """paths_out: list of int32 arrays (la_p + 2, pre-set -1)."""
        at = np.concatenate([[0], np.cumsum([len(x) for x in paths_out])])
        path = np.concatenate(paths_out)
        w = Wins.tops(self.ops.la, self.ops.lb).live()
        while len(w):
            c, tr = _sweep_depth(self.ops, w, self.sweeper, False)[:2]
            w, _ = _spawn(w, c, tr, path, at[w.p])
        for p, dst in enumerate(paths_out):
            dst[:] = path[at[p]:at[p + 1]]


# --------------------------------------------------------------------
# batched tree-level merges (all modes, lockstep recursions)
# --------------------------------------------------------------------

def run_merge_batch(aligners, paths):
    """Run every aligner's flip-free Hirschberg recursion in lockstep:
    each depth stacks ALL problems' chunks on the launch axis (a chunk
    holds one problem's windows, since every problem brings its own
    per-column data; this works for all three operand kinds).  All
    aligners must share padded (VR, Cpad, Wmax) dims.  Returns
    [(margin_sum, margin_count)] per problem."""
    ops = Operands.of_aligners(aligners)
    at = np.concatenate([[0], np.cumsum([len(x) for x in paths])])
    path = np.concatenate(paths)
    w = Wins.tops(ops.la, ops.lb).live()
    rec = []
    while len(w):
        c, tr, _, _, has2, margin = _sweep_depth(ops, w, aligners[0].sweeper,
                                                 True)
        rec.append((w.p[has2], w.key[has2], w.depth[has2], margin[has2]))
        w, _ = _spawn(w, c, tr, path, at[w.p])
    for p, dst in enumerate(paths):
        dst[:] = path[at[p]:at[p + 1]]
    return [m[:2] for m in _margin_sums(len(aligners), rec)]


# --------------------------------------------------------------------
# batched refinement flip trials (one merge, K perturbed recursions)
# --------------------------------------------------------------------

def run_flip_trials(aligners, paths):
    """K flip-perturbation trials of ONE merge in lockstep.  Every
    trial's recursion is DFS (flip_counter consumes low-margin meets in
    preorder, aln_refine.c trial semantics), so each step takes ONE
    window per live trial; the trials share operands (aligners[0]'s), so
    their windows pack into shared grids.  Returns [(margin_sum,
    margin_count, margins)] per trial."""
    a0 = aligners[0]
    ops = Operands.of_aligners([a0])
    K = len(aligners)
    at = np.concatenate([[0], np.cumsum([len(x) for x in paths])])
    path = np.concatenate(paths)
    top = Wins.tops([a0.la], [a0.lb]).live()
    stacks = [[top] if len(top) else [] for _ in range(K)]
    rec = []
    while True:
        owner = [t for t in range(K) if stacks[t]]
        if not owner:
            break
        w = Wins.cat([stacks[t].pop() for t in owner])
        owner = np.array(owner, np.int64)
        c, tr, c2, tr2, has2, margin = _sweep_depth(ops, w, a0.sweeper,
                                                    False)
        for i, t in enumerate(owner.tolist()):
            aln = aligners[t]
            if aln.flip_threshold > 0.0 and has2[i]:
                if margin[i] < aln.flip_threshold:
                    if aln.flip_trial > 0 and (
                            aln.flip_counter % aln.flip_stride
                            == aln.flip_trial - 1):
                        c[i], tr[i] = c2[i], tr2[i]
                    aln.flip_counter += 1
        rec.append((owner[has2], w.key[has2], w.depth[has2], margin[has2]))
        kids, src = _spawn(w, c, tr, path, at[owner])
        # DFS order: push right then left so left pops first
        for k in range(len(src) - 1, -1, -1):
            stacks[int(owner[src[k]])].append(kids.take([k]))
    for t, dst in enumerate(paths):
        dst[:] = path[at[t]:at[t + 1]]
    return _margin_sums(K, rec)


# --------------------------------------------------------------------
# native-runtime hook adapter
# --------------------------------------------------------------------

def exactness_canary(sweeper):
    """One small seq x seq problem through the device wavefront vs the
    native oracle.  Bit-exactness rests on the compiler not contracting
    mul/add chains or reassociating maxes; if a compiler change ever
    breaks that, this turns silent loss of byte-parity into a loud error
    at engine start.  Returns the canary's record; raises on a
    mismatch."""
    L = native.lib()
    rng = np.random.default_rng(1234)
    ap = P.aln_param_init(P.BIOTYPE_PROTEIN, P.KALIGN_TYPE_PROTEIN,
                          -1.0, -1.0, -1.0, 1)
    subm = np.ascontiguousarray(ap.subm.astype(np.float32).reshape(-1))
    la, lb = 33, 47
    s1 = rng.integers(0, 23, la).astype(np.uint8)
    s2 = rng.integers(0, 23, lb).astype(np.uint8)
    g = (np.float32(ap.gpo), np.float32(ap.gpe), np.float32(ap.tgpe))
    path_ref = np.full(lb + 2, -1, np.int32)
    info = np.zeros(3, np.float32)
    L.kt_run_align_single(0, s1.ctypes.data, s2.ctypes.data, None, None,
                          la, lb, 0, subm, g[0], g[1], g[2],
                          np.float32(0.7), None, lb, 0.0, 0, 1, 0,
                          path_ref, info)
    aln = ExactAligner(0, s1, s2, None, None, la, lb, 0,
                       subm.reshape(23, 23), g[0], g[1], g[2],
                       np.float32(0.7), None, sweeper=sweeper)
    path_dev = np.full(la + 2, -1, np.int32)
    msum, mcount, _ = aln.run(path_dev)
    if not (np.array_equal(path_ref[:la + 2], path_dev)
            and np.float32(msum) == info[0]
            and mcount == int(info[1])):
        raise RuntimeError(
            "bit-exactness canary failed: the sweep on "
            f"{sweeper.device} no longer reproduces the reference float "
            "op order (compiler FMA contraction / reassociation?).  Use "
            "engine='host' and report this.")
    return dict(device=str(sweeper.device), la=la, lb=lb,
                margin_sum=float(msum), margin_count=int(mcount),
                path_equal=True)


def _u8(ptr, n):
    return np.ctypeslib.as_array(ctypes.cast(ptr, _u8p), shape=(n,))


def _f32(ptr, n):
    return np.ctypeslib.as_array(ctypes.cast(ptr, _f32p), shape=(n,))


def _i32(ptr, n):
    return np.ctypeslib.as_array(ctypes.cast(ptr, _i32p), shape=(n,))


class ExactDpBackend:
    """The native runtime's four DP hooks (native.DP_HOOK_TYPE and the
    batched pairwise, merge and trial hooks): each receives raw pointers
    from the runtime, wraps them as numpy views, and runs the exact
    aligners with their sweeps on ``device``.  A Python exception inside
    a callback makes it return 1, which stops kt_align_msa; its traceback
    is kept in ``last_error``.  ``hook_s`` adds up the seconds spent
    inside the callbacks."""

    def __init__(self, device="cpu"):
        self.sweeper = Sweeper(device)
        self.calls = 0
        self.hook_s = 0.0
        self.last_error = None
        self.canary = None
        # the ctypes callback objects stay referenced while installed
        self._cbs = (native.DP_HOOK_TYPE(self._guard(self._call)),
                     native.PAIRWISE_HOOK_TYPE(self._guard(
                         self._call_pairwise)),
                     native.MERGE_BATCH_HOOK_TYPE(self._guard(
                         self._call_merge_batch)),
                     native.TRIAL_BATCH_HOOK_TYPE(self._guard(
                         self._call_trial_batch)))

    def _guard(self, fn):
        def callback(*args):
            t0 = time.perf_counter()
            try:
                self.calls += 1
                fn(*args)
                return 0
            except Exception:
                import traceback
                self.last_error = traceback.format_exc()
                return 1
            finally:
                self.hook_s += time.perf_counter() - t0
        return callback

    def run_canary(self):
        """The canary on this backend's device (once; it raises on a
        mismatch); returns its record."""
        if self.canary is None:
            self.canary = exactness_canary(self.sweeper)
        return self.canary

    def install(self):
        """Run the canary once, then set the four hooks.  The caller
        serialises install -> kt_align_msa -> uninstall
        (engine._HOOK_LOCK): the hooks are process-wide."""
        self.run_canary()
        self.last_error = None
        dp, pairwise, merge_batch, trial_batch = self._cbs
        native.set_dp_hook(dp)
        native.set_pairwise_hook(pairwise)
        native.set_merge_batch_hook(merge_batch)
        native.set_trial_batch_hook(trial_batch)

    @staticmethod
    def uninstall():
        native.set_dp_hook(None)
        native.set_pairwise_hook(None)
        native.set_merge_batch_hook(None)
        native.set_trial_batch_hook(None)

    def _aligner(self, mode, seq1, seq2, prof1, prof2, la, lb, sip, subm,
                 gpo, gpe, tgpe, soff, bonus, bstride, flip_threshold=0.0,
                 flip_trial=0, flip_stride=1):
        """An ExactAligner over the runtime's operands (raw pointers)."""
        mode = int(mode)
        bstride = int(bstride)
        s1 = _u8(seq1, la) if mode == 0 else None
        s2 = _u8(seq2, lb) if mode != 2 else None
        p1 = _f32(prof1, (la + 2) * 64) if mode != 0 else None
        p2 = _f32(prof2, (lb + 2) * 64) if mode == 2 else None
        sm = _f32(subm, 529).reshape(23, 23) if mode == 0 else None
        bon = _f32(bonus, la * bstride + 1) if bonus else None
        return ExactAligner(mode, s1, s2, p1, p2, la, lb, int(sip), sm,
                            gpo, gpe, tgpe, soff, bon, flip_threshold,
                            flip_trial, flip_stride, bstride=bstride,
                            sweeper=self.sweeper)

    def _call(self, mode, seq1, seq2, prof1, prof2, len_a, len_b, sip,
              subm, gpo, gpe, tgpe, soff, bonus, bstride,
              flip_threshold, flip_trial, flip_stride,
              path_out, info_out, margins_out, margins_cap):
        la, lb = int(len_a), int(len_b)
        aln = self._aligner(mode, seq1, seq2, prof1, prof2, la, lb, sip,
                            subm, gpo, gpe, tgpe, soff, bonus, bstride,
                            flip_threshold, flip_trial, flip_stride)
        msum, mcount, mlist = aln.run(_i32(path_out, la + 2))
        info = _f32(info_out, 2)
        info[0] = msum
        info[1] = np.float32(mcount)
        if margins_out and margins_cap > 0:
            marr = _f32(margins_out, margins_cap)
            k = min(len(mlist), int(margins_cap))
            marr[:k] = mlist[:k]

    def _call_merge_batch(self, n, modes, seqs_a, seqs_b, profs_a, profs_b,
                          lens_a, lens_b, sips, bonuses, bstrides,
                          gpos, gpes, tgpes, soffs, subm,
                          paths_out, stride, margin_sums, margin_counts):
        n = int(n)
        stride = int(stride)
        aligners = [self._aligner(
            modes[m], seqs_a[m], seqs_b[m], profs_a[m], profs_b[m],
            int(lens_a[m]), int(lens_b[m]), sips[m], subm, gpos[m], gpes[m],
            tgpes[m], soffs[m], bonuses[m], bstrides[m]) for m in range(n)]
        # shared padded dims for grid stacking: the tallest problem's.
        # run_merge_batch gives every problem grids of its own (their
        # column addends differ), so a VR past that (kalign_tpu packs to
        # its budget here) packs nothing and only pads every grid with
        # rows to sweep and bytes to upload
        VR = max(a.VR for a in aligners)
        C = max(a.Cpad for a in aligners)
        for a in aligners:
            a.VR = VR
            a.Cpad = C
            a.Wmax = VR
        flat = _i32(paths_out, n * stride)
        paths = [flat[m * stride:(m + 1) * stride] for m in range(n)]
        stats = run_merge_batch(aligners, paths)
        ms, mc = _f32(margin_sums, n), _i32(margin_counts, n)
        for m, (msum, cnt) in enumerate(stats):
            ms[m] = msum
            mc[m] = cnt

    def _call_trial_batch(self, mode, seq1, seq2, prof1, prof2,
                          len_a, len_b, sip, subm, gpo, gpe, tgpe, soff,
                          bonus, bstride, n_trials, flip_threshold,
                          flip_stride, paths_out, path_stride,
                          margin_sums, margin_counts):
        la, lb = int(len_a), int(len_b)
        stride = int(path_stride)
        K = int(n_trials) - 1
        aligners = [self._aligner(mode, seq1, seq2, prof1, prof2, la, lb,
                                  sip, subm, gpo, gpe, tgpe, soff, bonus,
                                  bstride, flip_threshold, k,
                                  int(flip_stride))
                    for k in range(1, K + 1)]
        flat = _i32(paths_out, K * stride)
        paths = [flat[k * stride:(k + 1) * stride] for k in range(K)]
        stats = run_flip_trials(aligners, paths)
        ms, mc = _f32(margin_sums, K), _i32(margin_counts, K)
        for k, (msum, cnt, _) in enumerate(stats):
            ms[k] = msum
            mc[k] = cnt

    def _call_pairwise(self, n_pairs, seqs_a, lens_a, seqs_b, lens_b,
                       subm, gpo, gpe, tgpe, paths_out, stride):
        n = int(n_pairs)
        stride = int(stride)
        sm = _f32(subm, 529).reshape(23, 23)
        flat = _i32(paths_out, n * stride)
        # bound the upfront match-matrix memory: an NxK pre-pass at 16k
        # sequences is ~80k pairs; process in slices
        CAP = 2048
        for lo in range(0, n, CAP):
            hi = min(lo + CAP, n)
            pairs = [(_u8(seqs_a[p], int(lens_a[p])),
                      _u8(seqs_b[p], int(lens_b[p])))
                     for p in range(lo, hi)]
            paths = [flat[p * stride:(p + 1) * stride]
                     for p in range(lo, hi)]
            ExactPairBatch(pairs, sm, gpo, gpe, tgpe,
                           self.sweeper).run(paths)
