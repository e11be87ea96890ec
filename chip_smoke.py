#!/usr/bin/env python3
"""Smoke run of kalign_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit, then the CUDA
     kernels and the native tree library built from this checkout;
  2. edge cases: every hand-written kernel held against its plain
     PyTorch version on the same CUDA tensors (bitwise / exact), with
     la = 0 and lb = 0 problems, short and odd-sized inputs;
  3. the fast path: a 2,000-sequence protein family (270-330 residues,
     made from a seed) aligned with kalign_tpu_torch.align_msa(mode=
     "fast") on the card; the output is checked and every kernel of the
     path must have launched;
  4. the default path: a 2,000-sequence 16S-V4-like DNA family (240-270
     nt, made from a seed) aligned with align_msa(mode="default"), anchor
     consistency with 5 anchors: ~10,000 map DPs on the fused kernel,
     then the progressive pass with the consistency bonus; checked the
     same way, all six kernels must have launched;
  5. both paths once more under torch.profiler: device time by kernel,
     each of the six kernels' total device time and launches, and the
     device's idle share;
  6. main-path shapes: every kernel held bitwise against its plain
     version again, at the shapes and problem lengths the paths gave it
     (its largest launch; for the row kernel also its widest and the
     default path's largest launch of few problems, each under every
     block size that fits; for the prefix sums also the widest row
     launch's [B, L2p]), and timed there beside its plain version and its
     bound; the fused kernel also beside the materialised route
     (torch.bmm + lanewise kernel) on the same inputs;
  7. the same package on the card and on the CPU: BB30014 and a
     150-sequence protein family in --fast mode, BB30014 and a
     250-sequence DNA family (one 2,048-problem fused launch) in default
     mode: identical FASTA, or equal per-merge scores where a near-tie
     resolved differently;
  8. one JSON line with every kernel's numbers, the nvidia-smi line, and
     the last line {"ok": true, "device": {...}}.
Without a card, or outside a checkout of the repository, it prints no
result and exits non-zero.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s device memory; 67 TFLOP/s
# fp32 counts a fused multiply-add as two operations, so plain fp32
# add/max/compare ops run at 33.5e12/s; integer ALU lanes are half the
# fp32 lanes (64 per SM): 16.7e12 int32 ops/s, a 64-bit logic op or add
# costing two of them.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.7e12
# fp32 operations per DP cell of the Gotoh kernels (bias 3, diagonal
# candidates 4, A 1, GB 4, GA 3, decision compares 4); the fused kernel
# adds nc multiplies and nc - 1 adds for the match
GOTOH_OPS_PER_CELL = 19
# 64-bit operations per (pair, text symbol, live block) of the BPM kernel
BPM_OPS_PER_BLOCK_STEP = 17

PROTEIN = "ARNDCQEGHILKMFPSTWYV"
DNA = "ACGT"

KERNELS = {
    "gotoh_row": ("kalign_tpu_torch/csrc/gotoh_row.cu",
                  "kalign_tpu/tpu/gotoh_pallas.py:272 (_kernel :112)"),
    "gotoh_lanewise": ("kalign_tpu_torch/csrc/gotoh_lanewise.cu",
                       "kalign_tpu/tpu/gotoh_lanewise.py:357 (_kernel :132)"),
    "bpm": ("kalign_tpu_torch/csrc/bpm.cu",
            "kalign_tpu/tpu/bpm_pallas.py:213 (_kernel :80)"),
    "traceback": ("kalign_tpu_torch/csrc/traceback.cu",
                  "kalign_tpu/tpu/traceback.py:32 (_walk; XLA, not Pallas)"),
    "prefix_sum": ("kalign_tpu_torch/csrc/scan.cu",
                   "kalign_tpu/tpu/gotoh_pallas.py:309 (cumsum feeding "
                   "_kernel; XLA, not Pallas)"),
    "gotoh_fused": ("kalign_tpu_torch/csrc/gotoh_lanewise.cu",
                    "kalign_tpu/tpu/gotoh_lanewise.py:692 "
                    "(_fused_kernel :525)"),
}
# a substring of each kernel's name in a torch.profiler trace
PROFILE_NAMES = {"gotoh_row": "gotoh_row_kernel",
                 "gotoh_lanewise": "MatchStream", "bpm": "bpm_kernel",
                 "traceback": "walk_kernel", "prefix_sum": "prefix_sum_kernel",
                 "gotoh_fused": "FusedOperands"}
# the kernels each path must launch
PATH_KERNELS = {"fast": [k for k in KERNELS if k != "gotoh_fused"],
                "default": list(KERNELS)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def dev_us(e):
    """Device time of a torch.profiler key_averages() entry, in us."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, reps: int, name=None) -> float:
    """Device time per call of fn() from torch.profiler over reps calls:
    the mean duration of each kernel whose name holds `name` (of every
    kernel if None), summed over those kernels.  Means, not totals over
    reps: the trace may lack some of the launches.  Unlike
    cuda_time_ms it leaves out the host's time to launch them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [(dev_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0
            and (name is None or name in e.key)]
    if not hits:
        raise AssertionError("the profiler saw no device time")
    return sum(us / count for us, count in hits) / 1e3


def timed_once(fn):
    """(fn(), wall ms) of one call, the card drained before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def family(n: int, seed: int, root_len: int = 300, lo: int = 270,
           hi: int = 330, clades: int = 16, letters: str = PROTEIN,
           subs=(0.12, 0.08), max_indel: int = 4, p_del: float = 0.5):
    """A family from a seed: a root sequence, clade ancestors with
    subs[0] substitutions and short indels (1..max_indel, a deletion with
    probability p_del), members with subs[1] more; lengths kept within
    [lo, hi].  The defaults give the protein family."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(letters.encode(), np.uint8)
    na = len(alpha)

    def mutate(seq, sub, n_indel):
        seq = seq.copy()
        mask = rng.random(len(seq)) < sub
        seq[mask] = alpha[rng.integers(0, na, int(mask.sum()))]
        for _ in range(n_indel):
            k = int(rng.integers(1, max_indel + 1))
            pos = int(rng.integers(0, len(seq)))
            if rng.random() < p_del and len(seq) - k >= lo:
                seq = np.delete(seq, slice(pos, pos + k))
            elif len(seq) + k <= hi:
                seq = np.insert(seq, pos, alpha[rng.integers(0, na, k)])
        return seq

    root = alpha[rng.integers(0, na, root_len)]
    anc = [mutate(root, subs[0], int(rng.poisson(3))) for _ in range(clades)]
    out = []
    for i in range(n):
        s = mutate(anc[i % clades], subs[1], int(rng.poisson(2)))
        out.append(s.tobytes().decode())
    return out


def v4_family(n: int, seed: int):
    """16S rRNA V4-like amplicon variants (the 515F/806R region, ~253 nt):
    a 253-nt root, 16 clades at 8 % substitutions, members at 4 % more,
    indels of 1-3 nt biased to deletions; lengths 240-270."""
    return family(n, seed, root_len=253, lo=240, hi=270, letters=DNA,
                  subs=(0.08, 0.04), max_indel=3, p_del=0.6)


# ---------------------------------------------------------------------------
def phase_device_and_build():
    import torch
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    from kalign_tpu_torch import native
    from kalign_tpu_torch.gpu import _cuda
    from kalign_tpu_torch.utils.build import build_log
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        f_cuda = ex.submit(_cuda.library_path)
        f_tree = ex.submit(native.library_path)
        cuda_path, tree_path = f_cuda.result(), f_tree.result()
    secs = time.perf_counter() - t0
    _cuda.lib()
    native.lib()
    ptxas = [ln.strip() for ln in build_log(cuda_path).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": round(secs, 3),
          "cuda_lib": os.path.relpath(cuda_path, HERE),
          "tree_lib": os.path.relpath(tree_path, HERE), "ptxas": ptxas})
    return smi


def dp_problem(rng, L1p, L2p, la, lb, dev):
    """Random match scores and dyadic penalties for problems of lengths
    (la, lb) padded to L1p x L2p, centering bias on (eps 1e-3)."""
    import torch
    B = len(la)
    match = rng.standard_normal((B, L1p, L2p), dtype=np.float32) * 3
    pc = (-rng.integers(16, 96, size=(B, 3, L2p + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, size=(B, 3, L1p + 1)) / 32).astype(np.float32)
    la = np.asarray(la, np.int32)
    lb = np.asarray(lb, np.int32)
    slope = (lb / np.maximum(la, 1)).astype(np.float32)
    eps = np.full(B, 1e-3, np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)
    return dict(match=t(match), pc=t(pc), pr=t(pr), la=t(la), lb=t(lb),
                slope=t(slope), eps=t(eps), L1p=L1p, L2p=L2p)


def dp_args(p):
    return (p["match"], p["pc"], p["pr"], p["la"], p["lb"], p["slope"],
            p["eps"])


def valid_region_equal(dec_a, dec_b, la, lb):
    """Decisions equal on every problem's rows < la, columns < lb."""
    import torch
    B, L1p, L2p = dec_a.shape
    rows = torch.arange(L1p, device=dec_a.device)[None, :, None]
    cols = torch.arange(L2p, device=dec_a.device)[None, None, :]
    mask = (rows < la[:, None, None]) & (cols < lb[:, None, None])
    return bool(torch.equal(dec_a[mask], dec_b[mask]))


def dec_cells(lanewise, dec, L2p):
    from kalign_tpu_torch.gpu import gotoh_lanewise
    return gotoh_lanewise.unpack_dec(dec, L2p) if lanewise else dec


# largest |kernel - plain| seen per kernel over every comparison
MAX_ABS_ERR = {}


def hold(name: str, ok: bool, err: float, what: str):
    """Record a comparison; raise unless the kernel matched."""
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR.get(name, 0.0), err)
    if not ok:
        raise AssertionError(f"{name} {what}: the kernel disagrees with "
                             f"its plain version (max abs err {err})")


def abs_err(a, b) -> float:
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def hold_dp_outputs(name, lanewise, a, b, p, what):
    """Bitwise scores, equal end states and valid-region decisions."""
    import torch
    (da, sa, sta), (db, sb, stb) = a, b
    ok = (torch.equal(sa.view(torch.int32), sb.view(torch.int32))
          and torch.equal(sta, stb)
          and valid_region_equal(dec_cells(lanewise, da, p["L2p"]),
                                 dec_cells(lanewise, db, p["L2p"]),
                                 p["la"], p["lb"]))
    hold(name, ok, abs_err(sa, sb), what)


def hold_walks(a, b, la, lb, what):
    """Identical steps and counts; each walk consumes la rows, lb cols."""
    import torch
    (sa, na), (sb, nb) = a, b
    ok = (torch.equal(sa, sb) and torch.equal(na, nb)
          and torch.equal(((sa == 0) | (sa == 2)).sum(1).int(), la)
          and torch.equal(((sa == 0) | (sa == 1)).sum(1).int(), lb))
    hold("traceback", ok, max(abs_err(sa, sb), abs_err(na, nb)), what)


def hold_equal(name, a, b, what):
    import torch
    hold(name, torch.equal(a, b), abs_err(a, b), what)


def phase_edge_cases(dev):
    """Each kernel against its plain version on small and degenerate
    inputs (the wrappers' full function, lb == 0 fix-up included)."""
    import torch
    from kalign_tpu_torch.gpu import bpm, distances, gotoh_fused, \
        gotoh_lanewise, gotoh_row, scan
    from kalign_tpu_torch.gpu import traceback as tb
    rng = np.random.default_rng(0)

    # row Gotoh: B=64 at 384 x 384, with la=0, lb=0 and lb=L2p problems,
    # under every block size (2, 4 and 8 columns per thread); B=4 at
    # 256 x 2176, whose last block columns lie past L2p
    la = rng.integers(1, 385, size=64)
    lb = rng.integers(1, 385, size=64)
    la[[0, 2]] = 0
    lb[[1, 2]] = 0
    lb[3] = 384
    p = dp_problem(rng, 384, 384, la, lb, dev)
    row_k = gotoh_row.forward(*dp_args(p))
    row_ref = gotoh_row.forward_plain(*dp_args(p))
    hold_dp_outputs("gotoh_row", False, row_k, row_ref, p,
                    "64x384x384 with la=0/lb=0")
    for ch in gotoh_row.CHUNKS:
        cfg = gotoh_row.config_for(384, ch)
        hold_dp_outputs("gotoh_row", False, gotoh_row.run_dp(
            gotoh_row.prepare,
            lambda *a: gotoh_row.launch(*a, config=cfg), *dp_args(p)),
            row_ref, p, f"64x384x384 under {cfg}")
    la = rng.integers(1, 257, size=4)
    lb = rng.integers(1, 2177, size=4)
    la[0], lb[1], lb[2] = 0, 0, 2176
    w = dp_problem(rng, 256, 2176, la, lb, dev)
    hold_dp_outputs("gotoh_row", False, gotoh_row.forward(*dp_args(w)),
                    gotoh_row.forward_plain(*dp_args(w)), w,
                    f"4x256x2176 under {gotoh_row.launch_config(4, 2176)}")

    # lanewise Gotoh: B=1024 at 128 x 128, lengths 1..128 and 0
    la = rng.integers(1, 129, size=1024)
    lb = rng.integers(1, 129, size=1024)
    la[[3, 5]] = 0
    lb[[4, 5]] = 0
    q = dp_problem(rng, 128, 128, la, lb, dev)
    lw_k = gotoh_lanewise.forward(*dp_args(q))
    hold_dp_outputs("gotoh_lanewise", True, lw_k,
                    gotoh_lanewise.forward_plain(*dp_args(q)), q,
                    "1024x128x128 with la=0/lb=0")

    # fused Gotoh: B=1024 with la=0/lb=0 problems, operands of any float
    # value (the chain's order is the plain version's), nc=5 at 128 x 128
    # and nc=23 at 64 x 64
    for nc, L in ((5, 128), (23, 64)):
        la = rng.integers(1, L + 1, size=1024)
        lb = rng.integers(1, L + 1, size=1024)
        la[[3, 5]] = 0
        lb[[4, 5]] = 0
        f = dp_problem(rng, L, L, la, lb, dev)
        ops = [torch.from_numpy(rng.standard_normal(
            (1024, L, nc), dtype=np.float32)).to(dev) for _ in range(2)]
        args = (*ops, *dp_args(f)[1:])
        hold_dp_outputs("gotoh_fused", True, gotoh_fused.forward(*args),
                        gotoh_fused.forward_plain(*args), f,
                        f"1024x{L}x{L} nc={nc} with la=0/lb=0")

    # traceback over both decision layouts
    for walk, plain, r, (dec, _, st) in (
            (tb.walk_rows, tb.plain_rows, p, row_k),
            (tb.walk_lanewise, tb.plain_lanewise, q, lw_k)):
        args = (dec, r["la"], r["lb"], st, r["L1p"] + r["L2p"] + 2)
        hold_walks(walk(*args), plain(*args), r["la"], r["lb"],
                   f"{walk.__name__} {tuple(dec.shape)}")

    # prefix sums: strided views of R = 1, 33, 1000 rows (not multiples
    # of a block's rows) and W = 1, 129, 1408 columns (one column, past a
    # column tile), one at a time and three sets in one launch
    x = torch.from_numpy(rng.standard_normal((1000, 3, 1409),
                                             dtype=np.float32)).to(dev)
    views = [x[:R, k % 3, 1:W + 1] for k, (R, W) in enumerate(
        (R, W) for R in (1, 33, 1000) for W in (1, 129, 1408))]
    for v in views + [x[:3, 0, :]]:
        hold_equal("prefix_sum", scan.prefix_sum_f32(v), scan.plain(v),
                   str(tuple(v.shape)))
    sets = (views[8], views[4], views[0])
    for got, v in zip(scan.prefix_sums_f32(*sets), sets):
        hold_equal("prefix_sum", got, scan.plain(v),
                   f"{tuple(v.shape)} of three sets in one launch")

    # BPM: 2,048 sequences x 32 anchors, lengths 60-1,100 (patterns of
    # 1-16 blocks, texts longer than 1,024)
    N = 2048
    lens = rng.integers(60, 1101, size=N).astype(np.int32)
    tokens = np.zeros((N, int(lens.max())), np.uint8)
    for i in range(N):
        tokens[i, :lens[i]] = rng.integers(0, 13, size=lens[i])
    anchors = list(range(0, N, N // 32))
    pairs = distances.PairBatch(tokens, lens, anchors, dev)
    inp = pairs.inputs(0, pairs.n_pairs)
    hold_equal("bpm", bpm.bpm_batch(*inp), bpm.plain(*inp),
               "2048x32, lengths 60-1100")
    emit({"phase": "edge_cases", "ok": True})


# ---------------------------------------------------------------------------
def counters():
    from kalign_tpu_torch.gpu import bpm, gotoh_fused, gotoh_lanewise, \
        gotoh_row, scan
    from kalign_tpu_torch.gpu import traceback as tb
    return {"gotoh_row": gotoh_row, "gotoh_lanewise": gotoh_lanewise,
            "bpm": bpm, "traceback": tb, "prefix_sum": scan,
            "gotoh_fused": gotoh_fused}


def check_alignment(rows, seqs):
    if len(rows) != len(seqs):
        raise AssertionError("row count differs from the input")
    widths = {len(r) for r in rows}
    if len(widths) != 1:
        raise AssertionError(f"rows of unequal width: {sorted(widths)[:5]}")
    for i, (r, s) in enumerate(zip(rows, seqs)):
        if r.replace("-", "") != s:
            raise AssertionError(f"row {i} de-gapped differs from its input")
    return widths.pop()


def phase_path(path: str, seqs):
    """One alignment of seqs in mode ``path`` on the card, every launch
    count set to 0 just before it and read just after."""
    import torch
    import kalign_tpu_torch
    mods = counters()
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msa = kalign_tpu_torch.align_msa(seqs, mode=path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: m.launches for k, m in mods.items()}
    rows = msa.aligned_rows()
    width = check_alignment(rows, seqs)
    stats = msa.engine_stats
    routes = {}
    for b in stats["batches"]:
        key = f"{'maps' if b['maps'] else 'merges'} {b['route']}"
        routes.setdefault(key, []).append(
            f"{len(b['la'])}x{b['L1p']}x{b['L2p']}")
    emit({"phase": "path", "path": path, "sequences": len(seqs),
          "lengths": [min(map(len, seqs)), max(map(len, seqs))],
          "width": width, "wall_s": round(wall, 3),
          "phase_s": {k: round(v, 3) for k, v in msa.phase_times.items()},
          "mean_seq_distance": float(np.mean(msa.seq_distances)),
          "map_pairs": stats["map_pairs"],
          "row_merges": stats["row_merges"],
          "lanewise_merges": stats["lanewise_merges"],
          "fused_merges": stats["fused_merges"],
          "launches": launches, "launch_batches": routes,
          "levels": stats["levels"]})
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}; buckets per level: "
                             f"{stats['levels']}")
    return launches, stats


def phase_profile(path: str, seqs):
    """A path once more under torch.profiler: device time by kernel, and
    the device's busy share of the run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import kalign_tpu_torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kalign_tpu_torch.align_msa(seqs, mode=path)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6

    # device-side entries only (kernels and copies): an operator's
    # device time is also listed under the kernels it launched
    rows = sorted(((e.key, dev_us(e), e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    totals = {}
    for name, sub in PROFILE_NAMES.items():
        hit = [(us, c) for k, us, c in rows if sub in k]
        totals[name] = {"device_ms": round(sum(h[0] for h in hit) / 1e3, 3),
                        "launches": sum(h[1] for h in hit)}
    emit({"phase": "profile", "path": path,
          "wall_s": round(wall_us / 1e6, 3),
          "device_busy_s": round(busy_us / 1e6, 4),
          "device_idle_share": round(1.0 - busy_us / wall_us, 4),
          "kernels": totals,
          "top": [{"name": k[:80], "device_ms": round(us / 1e3, 3),
                   "calls": c} for k, us, c in rows[:12]]})


def bound(bytes_, ops, ops_per_s):
    """(bound ms, what bounds it) of a function moving bytes_ and doing
    ops operations at ops_per_s."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gotoh_bound(p, dec_bytes_per_cell, nc=0):
    """The cells this run's problems need (la x lb each): a match read (or,
    with nc operands per row and column, those read once instead) and a
    decision write per cell, the penalties of their rows and columns, and
    GOTOH_OPS_PER_CELL fp32 operations per cell, 2 * nc - 1 more to
    compute the match."""
    la = p["la"].cpu().numpy().astype(np.int64)
    lb = p["lb"].cpu().numpy().astype(np.int64)
    cells = float(np.sum(la * lb))
    match_bytes = 0 if nc else 4
    bytes_ = (cells * (match_bytes + dec_bytes_per_cell)
              + float(np.sum(la + lb)) * (12 + 4 * nc) + len(la) * 8)
    ops = GOTOH_OPS_PER_CELL + (2 * nc - 1 if nc else 0)
    return bound(bytes_, cells * ops, FP32_OPS_PER_S)


def hold_dp(name, mod, lanewise, p, reps):
    """Kernel vs plain DP on the same prepared inputs: bitwise, then the
    kernel timed over reps launches and the plain version once."""
    prep = mod.prepare(p["pc"], p["pr"], p["la"], p["lb"], p["slope"],
                       p["eps"])
    args = (p["match"], prep, p["la"], p["lb"])
    out = mod.launch(*args)
    ref, plain_ms = timed_once(lambda: mod.plain(*args))
    hold_dp_outputs(name, lanewise, out, ref, p,
                    f"{len(p['la'])}x{p['L1p']}x{p['L2p']}")
    ms = cuda_time_ms(lambda: mod.launch(*args), reps=reps)
    return out, ms, plain_ms


def shape_of(p):
    return f"{len(p['la'])}x{p['L1p']}x{p['L2p']}"


def row_device_ms(p, reps=5):
    """The row kernel's device time on p under launch_config's block."""
    from kalign_tpu_torch.gpu import gotoh_row
    prep = gotoh_row.prepare(p["pc"], p["pr"], p["la"], p["lb"], p["slope"],
                             p["eps"])
    return device_ms(lambda: gotoh_row.launch(p["match"], prep, p["la"],
                                              p["lb"]),
                     reps, PROFILE_NAMES["gotoh_row"])


def row_blocks(p, reps):
    """The row kernel under every block size that fits p's width, each held
    bitwise against the plain version: {columns per thread: (threads,
    ms)}."""
    from kalign_tpu_torch.gpu import gotoh_row
    prep = gotoh_row.prepare(p["pc"], p["pr"], p["la"], p["lb"], p["slope"],
                             p["eps"])
    args = (p["match"], prep, p["la"], p["lb"])
    ref = gotoh_row.launch(*args)
    out = {}
    for ch in gotoh_row.CHUNKS:
        cfg = gotoh_row.config_for(p["L2p"], ch)
        if cfg is None:
            continue
        run = lambda: gotoh_row.launch(*args, config=cfg)
        hold_dp_outputs("gotoh_row", False, run(), ref, p,
                        f"{shape_of(p)} under {cfg}")
        out[ch] = (cfg.threads, cuda_time_ms(run, reps=reps))
    return out


def phase_main_shapes(dev, stats, stats_default, seqs):
    """Each kernel at the shapes and lengths a path gave it: the row,
    lanewise, traceback, prefix-sum and BPM kernels at the fast path's,
    the fused kernel at the default path's."""
    import torch
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch.core import alphabet as alpha
    from kalign_tpu_torch.core import params as P
    from kalign_tpu_torch.core.msa import Msa
    from kalign_tpu_torch.gpu import bpm, distances, gotoh_fused, \
        gotoh_lanewise, gotoh_row, scan
    from kalign_tpu_torch.gpu import traceback as tb
    from kalign_tpu_torch.gpu.engine import leaf_operands
    rng = np.random.default_rng(1)
    out = {}

    def batch(lanewise, key, st=stats, route=None):
        route = route or ("lanewise" if lanewise else "row")
        return max((b for b in st["batches"] if b["route"] == route),
                   key=key)

    def cells(b):
        return int(np.sum(b["la"].astype(np.int64) * b["lb"]))

    def problem(b):
        return dp_problem(rng, b["L1p"], b["L2p"], b["la"], b["lb"], dev)

    # row kernel: its largest launch (by the cells its lengths need), its
    # widest, and the default path's largest launch of few problems (an
    # upper tree level); each timed under launch_config's block and under
    # every other block that fits
    p = problem(batch(False, cells))
    row_out, ms, plain_ms = hold_dp("gotoh_row", gotoh_row, False, p, 20)
    out["gotoh_row"] = dict(ms=ms, plain_ms=plain_ms, shape=shape_of(p),
                            device_ms=row_device_ms(p),
                            block=gotoh_row.launch_config(
                                len(p["la"]), p["L2p"])._asdict(),
                            by_block=row_blocks(p, 20))
    out["gotoh_row"]["bound_ms"], out["gotoh_row"]["bound_by"] = \
        gotoh_bound(p, 1)
    for key, b, reps in (
            ("widest", batch(False, lambda b: (b["L2p"], b["L1p"])), 5),
            ("few", batch(False, lambda b: (-len(b["la"]), cells(b)),
                          stats_default), 10)):
        pk = problem(b)
        _, k_ms, k_plain_ms = hold_dp("gotoh_row", gotoh_row, False, pk, reps)
        b_ms, b_by = gotoh_bound(pk, 1)
        out["gotoh_row"][key] = dict(
            shape=shape_of(pk), ms=k_ms, plain_ms=k_plain_ms,
            device_ms=row_device_ms(pk), bound_ms=b_ms,
            bound_by=b_by, block=gotoh_row.launch_config(
                len(pk["la"]), pk["L2p"])._asdict(),
            by_block=row_blocks(pk, reps))
        if key == "widest":
            pw = pk
    emit({"phase": "main_shape", "kernel": "gotoh_row", **out["gotoh_row"]})

    # lanewise kernel: the main path's 1,024-problem leaf bucket
    q = problem(batch(True, cells))
    lw_out, ms, plain_ms = hold_dp("gotoh_lanewise", gotoh_lanewise, True,
                                   q, 10)
    out["gotoh_lanewise"] = dict(
        ms=ms, plain_ms=plain_ms,
        shape=f"{len(q['la'])}x{q['L1p']}x{q['L2p']}")
    out["gotoh_lanewise"]["bound_ms"], out["gotoh_lanewise"]["bound_by"] = \
        gotoh_bound(q, 0.5)
    emit({"phase": "main_shape", "kernel": "gotoh_lanewise",
          **out["gotoh_lanewise"]})

    # traceback: walks of the two buckets' decisions
    ms = plain_ms = bytes_ = 0.0
    for walk, plain, r, (dec, _, st) in (
            (tb.walk_rows, tb.plain_rows, p, row_out),
            (tb.walk_lanewise, tb.plain_lanewise, q, lw_out)):
        args = (dec, r["la"], r["lb"], st, r["L1p"] + r["L2p"] + 2)
        got = walk(*args)
        ref, t_plain = timed_once(lambda: plain(*args))
        hold_walks(got, ref, r["la"], r["lb"],
                   f"{walk.__name__} at the main path's shape")
        ms += cuda_time_ms(lambda: walk(*args), reps=20)
        plain_ms += t_plain
        # one decision byte read per step, the step rows written, and
        # la, lb, the end state and n
        bytes_ += int(got[1].sum()) + got[0].numel() + len(r["la"]) * 16
    b_ms, b_by = bound(bytes_, 0, FP32_OPS_PER_S)
    out["traceback"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by,
                            shape=f"{out['gotoh_row']['shape']} rows + "
                                  f"{out['gotoh_lanewise']['shape']} "
                                  "lanewise")
    emit({"phase": "main_shape", "kernel": "traceback", **out["traceback"]})

    # prefix sums: the row-side terminal-gap run of the leaf bucket, as
    # gotoh_lanewise.prepare takes it (a strided view), and the column gap
    # extensions of the widest row launch, as gotoh_row.prepare takes them
    out["prefix_sum"] = {}
    for key, x in (("leaf", q["pr"][:, 2, 1:]),
                   ("widest", pw["pc"][:, 1, 1:])):
        got = scan.prefix_sum_f32(x)
        ref, plain_ms = timed_once(lambda: scan.plain(x))
        hold_equal("prefix_sum", got, ref, f"{tuple(x.shape)} at the main "
                   "path's shape")
        b_ms, b_by = bound(x.numel() * 8, x.numel(), FP32_OPS_PER_S)
        cumsum = lambda: torch.cumsum(x, dim=1)
        t = dict(ms=cuda_time_ms(lambda: scan.launch(x), reps=50),
                 plain_ms=plain_ms, library_ms=cuda_time_ms(cumsum, reps=50),
                 device_ms=device_ms(lambda: scan.launch(x), 50,
                                     PROFILE_NAMES["prefix_sum"]),
                 library_device_ms=device_ms(cumsum, 50),
                 bound_ms=b_ms, bound_by=b_by,
                 shape=f"{x.shape[0]}x{x.shape[1]}")
        if key == "leaf":
            out["prefix_sum"].update(t)
        else:
            out["prefix_sum"][key] = t
    emit({"phase": "main_shape", "kernel": "prefix_sum",
          **out["prefix_sum"]})

    # BPM at the main path's N x 32 pairs
    msa = Msa.from_sequences(list(seqs))
    msa.quiet = True
    msa.sort_len_name()
    msa.encode(alpha.ALPHA_REDUCED_PROTEIN)
    anchors = E.pick_anchors(msa)
    codes = [sq.s for sq in msa.sequences]
    lens = np.array([len(c) for c in codes], np.int32)
    tokens = np.zeros((len(codes), int(lens.max())), np.uint8)
    for i, c in enumerate(codes):
        tokens[i, :len(c)] = c
    pairs = distances.PairBatch(tokens, lens, anchors, dev)
    inp = pairs.inputs(0, pairs.n_pairs)
    got = bpm.launch(*inp)
    (ref, work), plain_ms = timed_once(
        lambda: bpm.plain(*inp, count_work=True))
    hold_equal("bpm", got, ref, "at the main path's pairs")
    ms = cuda_time_ms(lambda: bpm.launch(*inp), reps=20)
    b_ms, b_by = bound(int(lens.sum()) + inp[3].numel() * 8
                       + len(inp[1]) * 16,
                       work * BPM_OPS_PER_BLOCK_STEP * 2, INT32_OPS_PER_S)
    out["bpm"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                      shape=f"{len(codes)}x{len(anchors)} pairs")
    emit({"phase": "main_shape", "kernel": "bpm", **out["bpm"]})

    # fused kernel: the default path's largest fused launch (map DPs),
    # its real lengths, the engine's own operands (one-hot rows against
    # rows of the DNA substitution matrix, integer-valued) from random
    # nucleotide codes, the map DPs' penalties and eps = 0
    fb = batch(True, cells, stats_default, "fused")
    B, L1p, L2p = len(fb["la"]), fb["L1p"], fb["L2p"]
    ap = P.aln_param_init(P.BIOTYPE_DNA, 0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    la_d, lb_d = t(fb["la"]), t(fb["lb"])
    tok = t(rng.integers(0, 4, size=(2 * B, max(L1p, L2p))).astype(np.uint8))
    lhs, rhs, pc, pr = leaf_operands(
        tok, t(np.asarray(ap.subm, np.float32)),
        t(np.array([-ap.gpo, -ap.gpe, -ap.tgpe], np.float32)),
        t(np.arange(B, dtype=np.int32)), t(np.arange(B, 2 * B,
                                                     dtype=np.int32)),
        la_d, lb_d, L1p, L2p)
    nc = 5
    x, y = lhs[:, :, :nc].contiguous(), rhs[:, :, :nc].contiguous()
    slope = lb_d.float() / torch.clamp(la_d.float(), min=1.0)
    prep = gotoh_fused.prepare(pc, pr, la_d, lb_d, slope,
                               torch.zeros(B, device=dev))
    f = dict(la=la_d, lb=lb_d, L1p=L1p, L2p=L2p)
    got = gotoh_fused.launch(x, y, prep, la_d, lb_d)
    ref, plain_ms = timed_once(
        lambda: gotoh_fused.plain(x, y, prep, la_d, lb_d))
    shape = f"{B}x{L1p}x{L2p}"
    hold_dp_outputs("gotoh_fused", True, got, ref, f, shape)
    del ref
    ms = cuda_time_ms(lambda: gotoh_fused.launch(x, y, prep, la_d, lb_d),
                      reps=10)

    # the materialised route on the same inputs: the 23-wide match
    # product, then the match-stream lanewise kernel; integer operands
    # make the product exact, so it gives the fused route's bits
    def materialised():
        match = torch.bmm(lhs, rhs.transpose(1, 2))
        return gotoh_lanewise.launch(match, prep, la_d, lb_d)
    hold_dp_outputs("gotoh_fused", True, got, materialised(), f,
                    f"{shape} fused vs bmm + lanewise")
    mat_ms = cuda_time_ms(materialised, reps=10)
    out["gotoh_fused"] = dict(ms=ms, plain_ms=plain_ms, shape=shape,
                              materialised_ms=mat_ms)
    out["gotoh_fused"]["bound_ms"], out["gotoh_fused"]["bound_by"] = \
        gotoh_bound(f, 0.5, nc)
    emit({"phase": "main_shape", "kernel": "gotoh_fused",
          **out["gotoh_fused"]})
    return out


def phase_gpu_vs_cpu():
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch.core import io as kio
    from kalign_tpu_torch.core.msa import Msa

    def bb30014():
        return kio.read_alignment(os.path.join(HERE, "tests", "data",
                                               "BB30014.tfa"))

    def dna250():
        # 100-128 nt: its 1,245 map DPs fill one 2,048-problem launch of
        # the fused route at 128 x 128, on the card and on the CPU
        return Msa.from_sequences(family(
            250, seed=3, root_len=114, lo=100, hi=128, letters=DNA,
            subs=(0.08, 0.04), max_indel=3, p_del=0.6))

    cases = [("BB30014", bb30014, 0),
             ("family150", lambda: Msa.from_sequences(family(150, seed=1)),
              0),
             ("BB30014-default", bb30014, 5),
             ("dna250-default", dna250, 5)]
    for name, make, consistency in cases:
        outs = {}
        for d in ("cuda", "cpu"):
            msa = make()
            msa.quiet = True
            msa = E.align_msa(msa, consistency_anchors=consistency, device=d)
            outs[d] = (kio.format_alignment(msa, "fasta"),
                       np.asarray(msa.task_confidence, np.float64))
            fused = [len(b["la"]) for b in msa.engine_stats["batches"]
                     if b["route"] == "fused"]
            if name.startswith("dna") and fused != [2048]:
                raise AssertionError(f"{name} on {d}: fused launches "
                                     f"{fused}, not one of 2,048")
        same = outs["cuda"][0] == outs["cpu"][0]
        c_gpu, c_cpu = outs["cuda"][1], outs["cpu"][1]
        rel = np.abs(c_gpu - c_cpu) / np.maximum(1.0, np.abs(c_cpu))
        emit({"phase": "gpu_vs_cpu", "case": name, "identical_fasta": same,
              "consistency": consistency, "merges": int(len(c_cpu)),
              "merges_with_other_score": int((c_gpu != c_cpu).sum()),
              "max_rel_score_diff": float(rel.max()) if len(rel) else 0.0})
        if not same and rel.max() > 1e-5:
            raise AssertionError(f"{name}: GPU and CPU alignments differ "
                                 "with unequal merge scores")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.exists(os.path.join(HERE, "kalign_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke: run from a checkout of the repository "
              "(kalign_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = phase_device_and_build()
    phase_edge_cases(dev)
    seqs = {"fast": family(2000, seed=0), "default": v4_family(2000, seed=2)}
    launches, stats = {}, {}
    for path in ("fast", "default"):
        launches[path], stats[path] = phase_path(path, seqs[path])
    for path in ("fast", "default"):
        phase_profile(path, seqs[path])
    shapes = phase_main_shapes(dev, stats["fast"], stats["default"],
                               seqs["fast"])
    phase_gpu_vs_cpu()
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = shapes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches["default"][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": MAX_ABS_ERR[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            **{k: v for k, v in t.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    total_s = time.perf_counter() - t_start
    emit({"phase": "total", "total_s": round(total_s, 1)})
    print(json.dumps({"kernels": kernels}))
    print(f"total_s {total_s:.1f}", file=sys.stderr)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
