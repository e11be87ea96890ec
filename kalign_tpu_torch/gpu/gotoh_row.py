"""Row Gotoh forward: the batched affine-gap DP, one DP row per step.

Kernel: csrc/gotoh_row.cu (replaces the TPU kernel
kalign_tpu/tpu/gotoh_pallas.py::_kernel, gotoh_forward_pallas:272).  The
note at the top of the CUDA source gives its design and what bounds it.
Rows wider than one block holds in registers (past 7,168 columns: the
widths kalign_tpu gives its XLA scan, tpu/gotoh.py::gotoh_forward) take
its cluster instantiation (``cluster_config``): a thread-block cluster of
up to 16 blocks per problem, each a band of the row's columns, handing
a halo to the next band once per row.  Past 16 bands
(CLUSTER_MAX_WIDTH = 114,688 columns) the wave route (``wave_config``,
gpu/gotoh_wave.py, csrc/gotoh_row_wave.cu) runs one problem at a time in
blocks of rows, its columns in a wavefront of up to WAVE_BANDS clusters
of WAVE_CLUSTER blocks that fills the card.

``forward`` launches the kernel for CUDA tensors and runs ``plain`` — the
same arithmetic in PyTorch, one row at a time — for CPU tensors.  Both
take the row-invariant vectors from one function, ``prepare``: the
prefix sums of the scan transform are computed once, left to right in
float32 (``scan.prefix_sum_f32``, on the tensors' device), so kernel and
plain version, on any device, see identical vectors and agree bitwise (a
prefix max is exact in any order).

Layouts follow gotoh_forward_pallas: match [B, L1p, L2p] f32 (L1p, L2p
multiples of 128), pens_cols [B, 3, L2p+1], pens_rows [B, 3, L1p+1]
(go/ge/tge, 1-based, negative), la/lb [B] int32, slope/bias_eps [B] f32
(centering bias |j*eps - i*(slope*eps)| subtracted from match[i-1, j-1]).
Returns dec [B, L1p, L2p] int8 (row r = DP row r+1, column c = DP column
c+1; only rows < la are written by the kernel), score [B] f32 and end
state [B] int32.
"""

import ctypes
from collections import namedtuple

import torch

from kalign_tpu_torch.gpu import _cuda
from kalign_tpu_torch.gpu.scan import prefix_sums_f32

NEG = -3.0e38
SMEM_LIMIT = 232448        # dynamic shared memory a Hopper block may use
COL_QUANTUM = 128          # L2p must be a multiple of this
# csrc/gotoh_row.cu's instantiations: columns per thread -> (most threads
# a block may have, match rows in the shared-memory ring)
CHUNKS = {4: (512, 8), 8: (896, 4)}
SLOT_FLOATS = 5            # per warp, two row parities
# the cluster instantiation: cluster sizes (blocks, one band each), the
# widest band (one block of the register design), the widest row, the
# halo ring (slots of floats per block, each with a full and an empty
# mbarrier of 8 bytes and a 4-byte credit word)
CLUSTER_SIZES = (2, 4, 8, 16)
BAND_MAX = 896 * 8
CLUSTER_MAX_WIDTH = CLUSTER_SIZES[-1] * BAND_MAX
HALO_SLOTS, HALO_FLOATS = 4, 8
# the plan: as many bands a problem as keep clusters x blocks within the
# card's 132 SMs, so every cluster of a launch runs at once; at each
# shape of the settings sweep (1 to 64 problems) that plan was the
# fastest, 16 bands even with one wholly past the row (PERF.md)
FILL_BLOCKS = 132
# bands wider than this take 8 columns a thread: fewer threads, so more
# blocks fit on an SM
BAND_CH4 = 1024
# the wave route (csrc/gotoh_row_wave.cu): clusters of WAVE_CLUSTER
# blocks (the portable cluster size) of at least WAVE_BLOCK_COLS columns,
# up to WAVE_BANDS clusters a problem, so 128 blocks of the card's 132
# SMs; a block asks for at least WAVE_SMEM_MIN bytes of shared memory, so
# that no two blocks share an SM (two would take more than an SM's
# 233,472 bytes, 1 KB a block reserved)
WAVE_CLUSTER = 8
WAVE_BLOCK_COLS = 256
WAVE_BANDS = 16
WAVE_SMEM_MIN = 116736
WAVE_MAX_THREADS = 512     # csrc/gotoh_row_wave.cu kWaveMaxThreads
WAVE_STRIP_FLOATS = 8      # a strip row's floats (its ring slot)

launches = 0
cluster_launches = 0

# route: "row" (one block per problem, ``band`` its columns) or "cluster"
# (``blocks`` blocks per problem, ``band`` columns each)
RowLaunch = namedtuple("RowLaunch", "route threads ch smem blocks band")
# the wave route: ``bands`` clusters of ``blocks`` blocks of ``band``
# columns each, over one problem
WaveLaunch = namedtuple("WaveLaunch", RowLaunch._fields + ("bands",))


def smem_bytes(threads, ch):
    """csrc/gotoh_row.cu::smem_bytes: four invariant vectors and the match
    ring over threads * ch columns, and the warp slots."""
    stages = CHUNKS[ch][1]
    return 4 * ((4 + stages) * threads * ch
                + threads // 32 * 2 * SLOT_FLOATS)


def config_for(L2p, ch):
    """RowLaunch of ch columns per thread, or None if it does not fit."""
    threads = -(-L2p // (32 * ch)) * 32
    smem = smem_bytes(threads, ch)
    if threads > CHUNKS[ch][0] or smem > SMEM_LIMIT:
        return None
    return RowLaunch("row", threads, ch, smem, 1, threads * ch)


def cluster_smem_bytes(threads, ch):
    """csrc/gotoh_row.cu::cluster_smem_bytes: per halo slot its two
    barriers, its floats and a credit word; then smem_bytes."""
    return (HALO_SLOTS * (2 * 8 + 4 * HALO_FLOATS + 4)
            + smem_bytes(threads, ch))


def band_config(blocks, band, ch):
    """RowLaunch of clusters of ``blocks`` bands of ``band`` columns, ch
    columns a thread (band a multiple of 32 * ch: whole warps)."""
    threads = band // ch
    return RowLaunch("cluster", threads, ch, cluster_smem_bytes(threads, ch),
                     blocks, band)


def cluster_config(B, L2p, blocks=None):
    """RowLaunch of the cluster instantiation for B problems of width L2p
    (up to CLUSTER_MAX_WIDTH): clusters of S blocks, S the largest of
    CLUSTER_SIZES with B * S <= FILL_BLOCKS, but at least the least that
    keeps a band within BAND_MAX (``blocks`` sets S); bands of
    ceil(L2p / S) columns rounded up to whole warps of 4 columns a thread
    (up to BAND_CH4 columns) or 8."""
    if blocks is None:
        need = next(s for s in CLUSTER_SIZES if s * BAND_MAX >= L2p)
        fit = max((s for s in CLUSTER_SIZES if B * s <= FILL_BLOCKS),
                  default=need)
        blocks = max(need, fit)
    band = -(-L2p // blocks)
    ch = 4 if band <= BAND_CH4 else 8
    return band_config(blocks, -(-band // (32 * ch)) * 32 * ch, ch)


def wave_smem_bytes(threads, ch):
    """csrc/gotoh_row_wave.cu::wave_smem_bytes: the cluster's halo
    header, the strip ring (a slot per match row of the ring and one
    more), then smem_bytes."""
    ring = 4 * WAVE_STRIP_FLOATS * (CHUNKS[ch][1] + 1)
    return cluster_smem_bytes(threads, ch) + ring


def wave_config(L2p, bands=WAVE_BANDS):
    """WaveLaunch of the wave route at width L2p over at most ``bands``
    clusters: blocks of w columns, w the least of at least
    WAVE_BLOCK_COLS that keeps bands * WAVE_CLUSTER blocks over the row,
    rounded up to whole warps of 4 columns a thread (up to BAND_CH4
    columns) or 8; as many clusters as cover L2p.  Raises past blocks
    of WAVE_MAX_THREADS threads (524,288 columns at 16 bands)."""
    S = WAVE_CLUSTER
    w = max(WAVE_BLOCK_COLS, -(-L2p // (bands * S)))
    ch = 4 if w <= BAND_CH4 else 8
    w = -(-w // (32 * ch)) * 32 * ch
    if w > WAVE_MAX_THREADS * ch:
        raise ValueError(f"row Gotoh kernel: {L2p} columns exceed the "
                         f"wave route's {bands * S * WAVE_MAX_THREADS * 8}")
    threads = w // ch
    return WaveLaunch("wave", threads, ch,
                      max(wave_smem_bytes(threads, ch), WAVE_SMEM_MIN), S, w,
                      -(-L2p // (S * w)))


def launch_config(B, L2p):
    """Block size and columns per thread of the row kernel for B problems
    of width L2p: 4 columns per thread (up to 512 threads), 8 beyond
    that; past 896 threads of 8 the cluster instantiation, and past
    CLUSTER_MAX_WIDTH the wave route (WaveLaunch)."""
    if L2p <= 0 or L2p % COL_QUANTUM:
        raise ValueError(f"row Gotoh kernel: L2p={L2p} is not a multiple "
                         f"of {COL_QUANTUM}")
    for ch in CHUNKS:
        cfg = config_for(L2p, ch)
        if cfg is not None:
            return cfg
    if L2p <= CLUSTER_MAX_WIDTH:
        return cluster_config(B, L2p)
    return wave_config(L2p)


def prepare(pens_cols, pens_rows, la, lb, slope, bias_eps):
    """Row-invariant vectors (gotoh_pallas.py:302-344) for the kernel and
    its plain version."""
    B = pens_cols.shape[0]
    W = pens_cols.shape[2] - 1
    L1p = pens_rows.shape[2] - 1
    dev = pens_cols.device
    f32 = dict(dtype=torch.float32, device=dev)
    goB = pens_cols[:, 0, 1:]
    geB = pens_cols[:, 1, 1:]
    tgeB = pens_cols[:, 2, 1:]
    goA = pens_rows[:, 0, :]
    geA = pens_rows[:, 1, :]
    tgeA = pens_rows[:, 2, :]
    C_norm, C_term, cum_tgeA = prefix_sums_f32(geB, tgeB,
                                               tgeA[:, 1:])  # cum: [B, L1p]
    pad1 = torch.zeros((B, 1), **f32)
    goB_next = torch.cat([goB[:, 1:], pad1], dim=1)        # goB[j+1]
    tgeB_next = torch.cat([tgeB[:, 1:], pad1], dim=1)
    cols = torch.arange(1, W + 1, device=dev)[None, :]
    ga0 = torch.where(cols <= lb[:, None], C_term,
                      torch.full((), NEG, **f32)).contiguous()
    goB_s = torch.cat([pad1, goB[:, :W - 1]], dim=1)       # goB[j-1]
    C_norm_next = torch.cat([C_norm[:, 1:], pad1], dim=1)
    C_term_next = torch.cat([C_term[:, 1:], pad1], dim=1)
    gnC_norm = goB_next - C_norm_next
    gnC_term = tgeB_next - C_term_next
    colpen = torch.stack([C_norm, C_term, gnC_norm, gnC_term, goB_s],
                         dim=0).contiguous()               # [5, B, W]

    gb0 = torch.cat([torch.full((B, 1), NEG, **f32), cum_tgeA[:, :L1p - 1]],
                    dim=1)                                 # GB[row-1, 0]
    rowpen = torch.stack([goA[:, 1:], geA[:, 1:], tgeA[:, 1:],
                          goA[:, :L1p], gb0], dim=2).contiguous()  # [B, L1p, 5]

    slope_eps = slope * bias_eps
    cols_eps = (cols.to(torch.float32) * bias_eps[:, None]).contiguous()
    rows_f = torch.arange(1, L1p + 1, device=dev).to(torch.float32)
    row_term = (rows_f[None, :] * slope_eps[:, None]).contiguous()
    lb0_score = torch.cat([torch.zeros((B, 1), **f32), cum_tgeA],
                          dim=1).gather(1, la[:, None].long())[:, 0]
    return dict(colpen=colpen, ga0=ga0, rowpen=rowpen, cols_eps=cols_eps,
                row_term=row_term, lb0_score=lb0_score)


def plain(match, prep, la, lb):
    """The kernel's arithmetic in PyTorch, vectorised over [B, L2p]."""
    B, L1p, W = match.shape
    dev = match.device
    f32 = dict(dtype=torch.float32, device=dev)
    C_norm, C_term, gnC_norm, gnC_term, goB_s = prep["colpen"]
    rowpen = prep["rowpen"]
    cols = torch.arange(1, W + 1, device=dev)[None, :]
    is_term_col = cols == lb[:, None]
    can_open = cols < lb[:, None]
    neg = torch.full((), NEG, **f32)
    negc = torch.full((B, 1), NEG, **f32)
    A = torch.full((B, W), NEG, **f32)
    GA = prep["ga0"].clone()
    GB = torch.full((B, W), NEG, **f32)
    dec = torch.zeros((B, L1p, W), dtype=torch.int8, device=dev)
    for r in range(L1p):
        row = r + 1
        goA_i = rowpen[:, r, 0:1]
        geA_i = rowpen[:, r, 1:2]
        tgeA_i = rowpen[:, r, 2:3]
        goA_prev = rowpen[:, r, 3:4]
        gb0_prev = rowpen[:, r, 4:5]
        m = match[:, r, :]
        m = m - torch.abs(prep["cols_eps"] - prep["row_term"][:, r:r + 1])
        a0 = torch.full((B, 1), 0.0 if row == 1 else NEG, **f32)
        diagA = torch.cat([a0, A[:, :-1]], dim=1)
        diagGA = torch.cat([negc, GA[:, :-1]], dim=1) + goB_s
        diagGB = torch.cat([gb0_prev, GB[:, :-1]], dim=1) + goA_prev
        best01 = torch.maximum(diagA, diagGA)
        A_row = torch.maximum(best01, diagGB) + m

        ge_eff = torch.where(is_term_col, tgeA_i, geA_i)
        go_eff = torch.where(is_term_col, tgeA_i, goA_i)
        gb_e = GB + ge_eff
        gb_o = A + go_eff
        GB_row = torch.maximum(gb_e, gb_o)

        last = (la == row)[:, None]
        C = torch.where(last, C_term, C_norm)
        gnC = torch.where(last, gnC_term, gnC_norm)
        u = torch.where(can_open, A_row + gnC, neg)
        cm = torch.cummax(u, dim=1).values
        cm_s = torch.cat([negc, cm[:, :-1]], dim=1)
        u_s = torch.cat([negc, u[:, :-1]], dim=1)
        GA_row = cm_s + C

        d = torch.where(diagGB >= best01, 2, torch.where(diagGA >= diagA, 1, 0))
        d = d | torch.where(cm_s > u_s, 4, 0) | torch.where(gb_e > gb_o, 8, 0)
        dec[:, r, :] = d.to(torch.int8)

        valid = (row <= la)[:, None]
        A = torch.where(valid, A_row, A)
        GA = torch.where(valid, GA_row, GA)
        GB = torch.where(valid, GB_row, GB)

    idx = (lb.long() - 1).clamp(min=0, max=W - 1)[:, None]
    in_range = (lb >= 1) & (lb <= W)

    def pick(x):
        return torch.where(in_range,
                           torch.maximum(x.gather(1, idx)[:, 0], neg), neg)

    ea, ega, egb = pick(A), pick(GA), pick(GB)
    score = torch.maximum(torch.maximum(ea, ega), egb)
    state = torch.where(ega > ea, torch.where(egb > ega, 2, 1),
                        torch.where(egb > ea, 2, 0)).to(torch.int32)
    return dec, score, state


_max_active = {}


def cluster_schedulable(cfg):
    """How many clusters of the plan the card can hold at once
    (cudaOccupancyMaxActiveClusters, cached per plan); raises where it
    cannot hold one: the launch would never run, and the wave route is no
    quiet substitute."""
    key = (cfg.threads, cfg.ch, cfg.blocks)
    if key not in _max_active:
        out = ctypes.c_int(0)
        _cuda.check(_cuda.lib().kt_gotoh_row_cluster_max_active(
            cfg.threads, cfg.ch, cfg.blocks, ctypes.byref(out)),
            "gotoh_row cluster occupancy")
        _max_active[key] = out.value
    if _max_active[key] < 1:
        raise RuntimeError(f"row Gotoh kernel: the card cannot schedule a "
                           f"cluster of {cfg.blocks} blocks of "
                           f"{cfg.threads} threads and {cfg.smem} bytes of "
                           "shared memory")
    return _max_active[key]


def launch(match, prep, la, lb, config=None):
    """Launch csrc/gotoh_row.cu on CUDA tensors, with launch_config's
    plan unless a RowLaunch is given; a WaveLaunch goes to the wave route
    (gpu/gotoh_wave.py), which takes the match one block of rows at a
    time."""
    global launches, cluster_launches
    match = match.contiguous()
    B, L1p, W = match.shape
    cfg = config or launch_config(B, W)
    if cfg.route == "wave":
        from kalign_tpu_torch.gpu import gotoh_wave
        return gotoh_wave.launch(lambda b, r0, r1, out=None: match[b, r0:r1],
                                 prep, la, lb, cfg)
    lib = _cuda.lib()
    if cfg.route == "cluster":
        smem = lib.kt_gotoh_row_cluster_smem_bytes(cfg.threads, cfg.ch)
    else:
        smem = lib.kt_gotoh_row_smem_bytes(cfg.threads, cfg.ch)
    if smem != cfg.smem:
        raise RuntimeError("row Gotoh kernel: shared-memory size differs "
                           "between csrc/gotoh_row.cu and launch_config")
    dev = match.device
    with torch.cuda.device(dev):
        _cuda.require_cuda("gotoh_row", match, prep["colpen"], prep["ga0"],
                           prep["rowpen"], prep["cols_eps"], prep["row_term"],
                           la, lb)
        if cfg.route == "cluster":
            cluster_schedulable(cfg)
        dec = torch.empty((B, L1p, W), dtype=torch.int8, device=dev)
        score = torch.empty(B, dtype=torch.float32, device=dev)
        state = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return dec, score, state
        args = (match.data_ptr(), *(prep[k].data_ptr() for k in (
            "colpen", "ga0", "rowpen", "cols_eps", "row_term")),
            la.data_ptr(), lb.data_ptr(), B, L1p, W, dec.data_ptr(),
            score.data_ptr(), state.data_ptr())
        stream = _cuda.stream(dev)
        if cfg.route == "cluster":
            rc = lib.kt_gotoh_row_cluster_forward(*args, cfg.threads, cfg.ch,
                                                  cfg.blocks, stream)
        else:
            rc = lib.kt_gotoh_row_forward(*args, cfg.threads, cfg.ch, stream)
        _cuda.check(rc, "gotoh_row")
    if cfg.route == "cluster":
        cluster_launches += 1
    else:
        launches += 1
    return dec, score, state


def default_bias(la, slope, bias_eps):
    zeros = torch.zeros(la.shape[0], dtype=torch.float32, device=la.device)
    return (zeros if slope is None else slope,
            zeros if bias_eps is None else bias_eps)


def fix_lb0(score, state, prep, lb):
    """Degenerate lb == 0: the path is one terminal column-0 gap run."""
    is_lb0 = lb == 0
    score = torch.where(is_lb0, prep["lb0_score"], score)
    state = torch.where(is_lb0, torch.full_like(state, 2), state)
    return score, state


def run_dp(prepare_fn, dp_fn, match, pens_cols, pens_rows, la, lb, slope,
           bias_eps):
    """prepare -> DP (kernel or plain version) -> lb == 0 fix-up."""
    slope, bias_eps = default_bias(la, slope, bias_eps)
    prep = prepare_fn(pens_cols, pens_rows, la, lb, slope, bias_eps)
    dec, score, state = dp_fn(match, prep, la, lb)
    score, state = fix_lb0(score, state, prep, lb)
    return dec, score, state


def pick_dp(name, match, launch_fn, plain_fn):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if match.is_cuda:
        return launch_fn
    if match.device.type == "cpu":
        return plain_fn
    raise ValueError(f"{name}: unsupported device {match.device}")


def forward(match, pens_cols, pens_rows, la, lb, slope=None, bias_eps=None):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    return run_dp(prepare, pick_dp("gotoh_row", match, launch, plain), match,
                  pens_cols, pens_rows, la, lb, slope, bias_eps)


def forward_plain(match, pens_cols, pens_rows, la, lb, slope=None,
                  bias_eps=None):
    """The plain version on any device (kernel comparisons on the card)."""
    return run_dp(prepare, plain, match, pens_cols, pens_rows, la, lb, slope,
                  bias_eps)
