#!/usr/bin/env python3
"""Time the kernels of this checkout against those of another checkout,
on one NVIDIA GPU, in one process.

    git archive <commit> kalign_tpu_torch | tar -x -C _proof/parent
    python3 scripts/ab_kernels.py --parent _proof/parent
    python3 scripts/ab_kernels.py --variant _proof/variant
    python3 scripts/ab_kernels.py --sweep
    python3 scripts/ab_kernels.py --parent _proof/parent --prepare
    python3 scripts/ab_kernels.py --parent _proof/parent --table

--parent: the row Gotoh kernel of an earlier checkout past 7,168
columns, its tiled instantiation called through its own C entry point
`kt_gotoh_row_tiled_forward` as of 1897761 (one block per problem,
column tiles, the previous row in a global scratch), against this
checkout's route there (the cluster instantiation): 8 x 512 x 8,192,
2 x 256 x 16,384, 64 x 256 x 8,192 (many problems: the cluster sizes'
fill rule) and 8 x 256 x 7,424 (one real problem: the long family's
largest launch), and the long_default path's largest launch
(the path runs once here to give it).  The two outputs must be bitwise
equal.

--prepare (with --parent): the match-preparation kernel
(csrc/prepare_match.cu) of the earlier checkout, called through its own
C entry point `kt_prepare_match` as of a9938c0 (one block per row and
1,024 columns, no plan arguments), against this checkout's, both entry
points called directly on the same prepared vectors (kernel time, no
wrapper work): at a plastome root merge's row block (1 x 3,440 x 156,032),
long_default's largest progressive launch (8 x 9,856 x 9,728) and a
serve-path launch (8 x 384 x 384), each with K = 5 random anchors, and
at 8 x 9,856 x 9,728 with K = 0 (no anchor: the bias alone) and K = 9;
the outputs held bitwise against each other and against
prepare.bonus_match; then this checkout's kernel at each shape under
other tiles (32 or launch_plan's threads across, 4 to 64 rows), held to
its own plan's bits.  The row-kernel comparison of --parent is skipped.

--table (with --parent): the BPM match-mask table kernel
(csrc/bpm.cu::peq_table_kernel) of the earlier checkout against this
checkout's, both through their own `kt_bpm_table` (the same C
interface), at the rows of the fast path's 2,000 proteins, large_default's
16,384 and long_default's 128 genomes (nblk 16), random codes at the
sequences' lengths (bpm_table_shape's inputs), both held bitwise against
bpm.plain_table.  The row-kernel comparison of --parent is skipped.

--sweep: the cluster instantiation's settings at those shapes: every
cluster size of gotoh_row.CLUSTER_SIZES that covers the row, each held
bitwise against launch_config's plan and timed (`device_ms`), with the
card's cudaOccupancyMaxActiveClusters for the plan.

--variant: the other checkout has this one's C interfaces (a variant of
one kernel, say): this checkout's own wrappers launch it, with their
library swapped for the variant's, and its outputs must be identical.
Besides BPM, the match-stream lanewise kernel at the fast path's leaf
bucket, the walk over the decisions of the fast path's largest row
launch (by cells), its lanewise leaf bucket and its widest row launch,
and the fused kernel at the largest launch of each shape the default
path gave it (the inputs of chip_smoke.py's main-shape phase; the two
paths run once here to give their launches).

--parent, --sweep and --variant may be given together.  Both versions see the
same tensors, their outputs are held bitwise equal, and each is timed
in turns (other, this, this, other): CUDA events over back-to-back
launches (`ms`, the host's launch time included) and chip_smoke.device_ms
(`device_ms`, the launches queued behind a spin kernel, so the host's
launch time is hidden).  Prints one JSON line per shape.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_cuda(checkout, name):
    """Another checkout's gpu/_cuda.py as a module of its own."""
    path = os.path.join(checkout, "kalign_tpu_torch", "gpu", "_cuda.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent",
                    help="an unpacked checkout of the earlier commit")
    ap.add_argument("--variant",
                    help="an unpacked checkout with this one's interfaces")
    ap.add_argument("--sweep", action="store_true",
                    help="time the cluster row kernel's settings")
    ap.add_argument("--prepare", action="store_true",
                    help="with --parent: the match-preparation kernels")
    ap.add_argument("--table", action="store_true",
                    help="with --parent: the BPM match-mask table kernels")
    args = ap.parse_args()
    if not (args.parent or args.variant or args.sweep):
        ap.error("give --parent, --variant, --sweep or more")
    if (args.prepare or args.table) and not args.parent:
        ap.error("--prepare and --table need --parent")
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kalign_tpu_torch.core import params as P
    from kalign_tpu_torch.gpu import _cuda, bpm, gotoh_fused, \
        gotoh_lanewise, gotoh_row
    from kalign_tpu_torch.gpu import traceback as tb
    from kalign_tpu_torch.gpu.engine import leaf_operands
    from kalign_tpu_torch.utils.build import build_log

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    old = var = None
    libs = {"this": _cuda}
    if args.parent:
        old = libs["parent"] = load_cuda(os.path.abspath(args.parent),
                                         "parent_cuda")
        old_lib = old.lib()
    if args.variant:
        var = libs["variant"] = load_cuda(os.path.abspath(args.variant),
                                          "variant_cuda")
        var.lib()
    _cuda.lib()
    # -Xptxas -v of each library's row (or match-preparation) kernels
    entry = ("prepare_match" if args.prepare else "peq_table"
             if args.table else "gotoh_row")
    ptxas = {k: cs.ptxas_lines(build_log(m.library_path()), entry)
             for k, m in libs.items()}
    print(json.dumps({"ptxas": ptxas}), flush=True)

    def on_variant(fn):
        """fn with this checkout's wrappers launching the variant's
        library."""
        def run():
            own = _cuda.lib
            _cuda.lib = var.lib
            try:
                return fn()
            finally:
                _cuda.lib = own
        return run

    def old_tiled(match, prep, la, lb):
        """The earlier checkout's kt_gotoh_row_tiled_forward under its
        own plan (its gotoh_row.tiled_config: as few tiles of at most
        512 threads x 8 columns as cover W, the block no wider than the
        tiles need)."""
        B, L1p, W = match.shape
        tiles = -(-W // (512 * 8))
        threads = -(-W // (tiles * 8 * 32)) * 32
        dec = torch.empty((B, L1p, W), dtype=torch.int8, device=dev)
        score = torch.empty(B, dtype=torch.float32, device=dev)
        state = torch.empty(B, dtype=torch.int32, device=dev)
        scratch = torch.empty((B, 2, 3, W), dtype=torch.float32, device=dev)
        rc = old_lib.kt_gotoh_row_tiled_forward(
            match.data_ptr(), *(prep[k].data_ptr() for k in (
                "colpen", "ga0", "rowpen", "cols_eps", "row_term")),
            la.data_ptr(), lb.data_ptr(), B, L1p, W, dec.data_ptr(),
            score.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            threads, _cuda.stream(dev))
        old.check(rc, "earlier gotoh_row_tiled")
        return dec, score, state

    def ab(fn_other, fn_new, reps, other="old"):
        t = {f"{other}_ms": [], "new_ms": [], f"{other}_device_ms": [],
             "new_device_ms": []}
        for which, fn in ((other, fn_other), ("new", fn_new),
                          ("new", fn_new), (other, fn_other)):
            t[f"{which}_ms"].append(cs.cuda_time_ms(fn, reps=reps))
            t[f"{which}_device_ms"].append(cs.device_ms(fn, reps))
        return t

    def show(kernel, label, shape, t, **extra):
        print(json.dumps({"kernel": kernel, "launch": label, "shape": shape,
                          **extra, **t}), flush=True)

    def against_variant(kernel, label, shape, fn, reps, same, **extra):
        """fn (this checkout) against the variant's library: outputs held
        equal by same(a, b), then timed in turns."""
        if var is None:
            return
        same(on_variant(fn)(), fn())
        show(kernel, label, shape, ab(on_variant(fn), fn, reps, "variant"),
             against="variant", **extra)

    if args.prepare:
        prepare_ab(cs, dev, old, old_lib, ab, show)
    if args.table:
        table_ab(cs, dev, old, old_lib, ab, show)

    seqs = {"fast": cs.family(2000, seed=0),
            "default": cs.v4_family(2000, seed=2)}

    # the row kernel past 7,168 columns: the parent's tiled instantiation
    # against this checkout's cluster route, and the cluster settings
    if (old and not (args.prepare or args.table)) or args.sweep:
        rng = np.random.default_rng(10)
        wide = {"8x512x8192": cs.dp_problem(rng, 512, 8192, [512] * 8,
                                            [8192] * 8, dev),
                "2x256x16384": cs.dp_problem(rng, 256, 16384, [256] * 2,
                                             [16384] * 2, dev),
                "64x256x8192": cs.dp_problem(rng, 256, 8192, [256] * 64,
                                             [8192] * 64, dev)}
        long_fast = cs.vs_align("long-fast", "cuda")[3]
        for label, st, maps in (("long family", long_fast, None),
                                ("long_default", cs.phase_path(
                                    "long_default", cs.long_genomes())[1],
                                 True)):
            b = max((b for b in st["batches"] if b["route"] == "row"
                     and b["L2p"] > 7168 and maps in (None, b["maps"])),
                    key=cs.batch_cells)
            wide[label] = cs.dp_problem(rng, b["L1p"], b["L2p"], b["la"],
                                        b["lb"], dev)
        for label, p in wide.items():
            prep = gotoh_row.prepare(p["pc"], p["pr"], p["la"], p["lb"],
                                     p["slope"], p["eps"])
            args_ = (p["match"], prep, p["la"], p["lb"])
            r_new = lambda: gotoh_row.launch(*args_)
            ref = r_new()
            cfg = gotoh_row.launch_config(len(p["la"]), p["L2p"])
            b_ms, b_by = cs.gotoh_bound(p, 1)
            if old:
                r_old = lambda: old_tiled(*args_)
                cs.hold_dp_outputs("gotoh_row_cluster", False, r_old(), ref,
                                   p, f"{label}: parent vs new, bitwise")
                show("gotoh_row_cluster", label, cs.shape_of(p),
                     ab(r_old, r_new, 5), against="parent tiled",
                     bound_ms=b_ms, bound_by=b_by, plan_new=cfg._asdict(),
                     ptxas_this=ptxas["this"], ptxas_parent=ptxas["parent"])
            if args.sweep:
                B, W = len(p["la"]), p["L2p"]
                plans = []
                for S in gotoh_row.CLUSTER_SIZES:
                    if S * gotoh_row.BAND_MAX < W:
                        continue
                    base = gotoh_row.cluster_config(B, W, blocks=S)
                    plans.append(base)
                    # the other columns per thread, where whole warps fit
                    for ch, (most, _) in gotoh_row.CHUNKS.items():
                        band = -(-W // S // (32 * ch)) * 32 * ch
                        if ch != base.ch and band // ch <= most:
                            plans.append(gotoh_row.band_config(S, band, ch))
                for c in plans:
                    run = lambda: gotoh_row.launch(*args_, config=c)
                    cs.hold_dp_outputs("gotoh_row_cluster", False, run(), ref,
                                       p, f"{label} under {c}")
                    show("gotoh_row_cluster", label, cs.shape_of(p),
                         {"device_ms": cs.device_ms(run, 5)},
                         against="settings", plan=c._asdict(),
                         chosen=c == cfg, bound_ms=b_ms,
                         max_active_clusters=gotoh_row.cluster_schedulable(
                             c))

    # BPM at the distance stages' pairs
    for path in ("fast", "default"):
        if var is None:
            break
        pairs, _ = cs.distance_stage(seqs[path], dev)
        inp = pairs.inputs(0, pairs.n_pairs)
        shape = f"{pairs.n_pairs // 32}x32 pairs, nblk={pairs.nblk}"
        b_new = lambda: bpm.launch(*inp)
        against_variant("bpm", f"{path} stage", shape, b_new, 10,
                        lambda a, b: cs.hold_equal("bpm", a, b,
                                                   "variant vs new"))
    if var is None:
        return 0

    stats = {p: cs.phase_path(p, s)[1] for p, s in seqs.items()}
    rng = np.random.default_rng(1)

    def cells(b):
        return int(np.sum(b["la"].astype(np.int64) * b["lb"]))

    def largest(st, route, key=cells):
        return max((b for b in st["batches"] if b["route"] == route),
                   key=key)

    def problem(b):
        return cs.dp_problem(rng, b["L1p"], b["L2p"], b["la"], b["lb"], dev)

    def same_dp(name, p):
        return lambda a, b: cs.hold_dp_outputs(name, True, a, b, p,
                                               "variant vs new")

    # the match-stream lanewise kernel and its walk at the leaf bucket
    q = problem(largest(stats["fast"], "lanewise"))
    prep = gotoh_lanewise.prepare(q["pc"], q["pr"], q["la"], q["lb"],
                                  q["slope"], q["eps"])
    a_new = lambda: gotoh_lanewise.launch(q["match"], prep, q["la"], q["lb"])
    lw_out = a_new()
    against_variant("gotoh_lanewise", "leaf", cs.shape_of(q), a_new, 10,
                    same_dp("gotoh_lanewise", q))

    # the walk over the row kernel's and the lanewise kernel's decisions
    walks = [("leaf", True, q, lw_out)]
    for label, key in (("largest", cells),
                       ("widest", lambda b: (b["L2p"], b["L1p"]))):
        p = problem(largest(stats["fast"], "row", key))
        rprep = gotoh_row.prepare(p["pc"], p["pr"], p["la"], p["lb"],
                                  p["slope"], p["eps"])
        walks.append((label, False, p,
                      gotoh_row.launch(p["match"], rprep, p["la"], p["lb"])))
    for label, lanewise, p, (dec, _, st) in walks:
        wa = (dec, p["la"], p["lb"], st, p["L1p"] + p["L2p"] + 2)
        w_new = lambda: (tb.walk_lanewise if lanewise else tb.walk_rows)(*wa)
        against_variant(
            "traceback", label, cs.shape_of(p), w_new, 20,
            lambda a, b: cs.hold_walks(a, b, p["la"], p["lb"],
                                       f"{label} variant vs new"),
            layout="lanewise" if lanewise else "rows",
            plan=tb.launch_plan(len(p["la"]), wa[4])._asdict())

    # the fused kernel at each launch shape of the default path
    ap_dna = P.aln_param_init(P.BIOTYPE_DNA, 0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    shapes = {}
    for b in stats["default"]["batches"]:
        if b["route"] == "fused":
            key = (len(b["la"]), b["L1p"], b["L2p"])
            if key not in shapes or cells(b) > cells(shapes[key]):
                shapes[key] = b
    nc = 5
    for (B, L1p, L2p), fb in sorted(shapes.items(),
                                    key=lambda kv: -cells(kv[1])):
        la, lb = t(fb["la"]), t(fb["lb"])
        tok = t(rng.integers(0, 4, size=(2 * B, max(L1p, L2p)))
                .astype(np.uint8))
        lhs, rhs, pc, pr = leaf_operands(
            tok, t(np.asarray(ap_dna.subm, np.float32)),
            t(np.array([-ap_dna.gpo, -ap_dna.gpe, -ap_dna.tgpe],
                       np.float32)),
            t(np.arange(B, dtype=np.int32)),
            t(np.arange(B, 2 * B, dtype=np.int32)), la, lb, L1p, L2p)
        x, y = lhs[:, :, :nc].contiguous(), rhs[:, :, :nc].contiguous()
        slope = lb.float() / torch.clamp(la.float(), min=1.0)
        fprep = gotoh_fused.prepare(pc, pr, la, lb, slope,
                                    torch.zeros(B, device=dev))
        f_new = lambda: gotoh_fused.launch(x, y, fprep, la, lb)
        against_variant("gotoh_fused", "map DPs", f"{B}x{L1p}x{L2p}", f_new,
                        10, same_dp("gotoh_fused", dict(la=la, lb=lb,
                                                        L2p=L2p)),
                        plan=gotoh_lanewise.launch_plan(L2p, nc)._asdict())
    return 0


# --prepare's shapes: (label, B, R, W, K)
PREPARE_SHAPES = (("plastome root-merge block", 1, 3440, 156032, 5),
                  ("long_default largest progressive", 8, 9856, 9728, 5),
                  ("serve", 8, 384, 384, 5),
                  ("no anchor", 8, 9856, 9728, 0),
                  ("K = 9", 8, 9856, 9728, 9))


def prepare_ab(cs, dev, old, old_lib, ab, show):
    """--prepare: the parent's kt_prepare_match against this checkout's
    on the same card tensors, in place on copies of one match block."""
    import torch
    from kalign_tpu_torch.gpu import _cuda, prepare
    rng = np.random.default_rng(16)
    this_lib = _cuda.lib()
    for label, B, R, W, K in PREPARE_SHAPES:
        t = lambda x: torch.from_numpy(x).to(dev)
        match = t(rng.standard_normal((B, R, W), dtype=np.float32) * 3)
        la = t(rng.integers(R // 2, R + 1, B).astype(np.int32))
        lb = t(rng.integers(W // 2, W + 1, B).astype(np.int32))
        eps = torch.full((B,), 1e-3, device=dev)
        bonus = cs.bonus_block(rng, B, R, W, K, dev)
        slope = (lb.float() / torch.clamp(la.float(), min=1.0)).contiguous()
        vecs = [eps, bonus[0].reshape(1)] + [x.contiguous()
                                             for x in bonus[1:]]
        ptrs = [slope.data_ptr()] + [x.data_ptr() for x in vecs]
        plan = prepare.launch_plan(B, R, W)
        work = {"old": match.clone(), "new": match.clone()}

        def run_old():
            old.check(old_lib.kt_prepare_match(
                work["old"].data_ptr(), *ptrs, B, K, R, W, 0, 0,
                _cuda.stream(dev)), "earlier prepare_match")

        def run_new():
            _cuda.check(this_lib.kt_prepare_match(
                work["new"].data_ptr(), *ptrs, B, K, R, W, 0, 0, plan.tx,
                plan.rows, _cuda.stream(dev)), "prepare_match")
        run_old()
        run_new()
        once = work["new"].clone()
        want = prepare.bonus_match(match, la, lb, eps, bonus)
        cs.hold_bits("prepare_match", work["new"], want,
                     f"{label}: new vs plain")
        cs.hold_bits("prepare_match", work["old"], want,
                     f"{label}: parent vs plain")
        del want
        b_ms, b_by = cs.bound(B * R * W * 8.0 + B * K * (R + W) * 8.0,
                              B * R * W * (5.0 + 2 * K), cs.FP32_OPS_PER_S)
        show("prepare_match", label, f"{B}x{R}x{W} K={K}",
             ab(run_old, run_new, 5), against="parent", bound_ms=b_ms,
             bound_by=b_by, plan_new=plan._asdict())
        # this kernel under other tiles: tx threads across, rows a tile
        sweep = {}
        for tx in sorted({plan.tx, 32}):
            for rows in (4, 8, 16, 32, 64):
                if rows < prepare.THREADS // tx:
                    continue
                other = match.clone()

                def run_plan():
                    _cuda.check(this_lib.kt_prepare_match(
                        other.data_ptr(), *ptrs, B, K, R, W, 0, 0, tx, rows,
                        _cuda.stream(dev)), "prepare_match")
                run_plan()
                cs.hold_bits("prepare_match", other, once,
                             f"{label}: tiles of {tx} x {rows}")
                sweep[f"{tx}x{rows}"] = cs.device_ms(run_plan, 5)
                del other
        show("prepare_match", label, f"{B}x{R}x{W} K={K}",
             {"device_ms_by_plan": sweep}, against="plans",
             plan_new=plan._asdict())
        del match, work, once
        torch.cuda.empty_cache()


def table_ab(cs, dev, old, old_lib, ab, show):
    """--table: the parent's kt_bpm_table against this checkout's on the
    same card tensors (bpm_table_shape's inputs), each into its own
    table."""
    import torch
    from kalign_tpu_torch.gpu import _cuda, bpm
    this_lib = _cuda.lib()
    for label, seqs in (("fast", cs.family(2000, seed=0)),
                        ("large_default", cs.large_family()),
                        ("long_default", cs.long_genomes())):
        lens = np.array([len(x) for x in seqs], np.int32)
        m = np.minimum(lens, bpm.MAX_PATTERN).astype(np.int32)
        nblk = -(-int(m.max()) // bpm.WORD)
        tokens = cs.random_tokens(np.random.default_rng(len(lens)), lens)
        tok = torch.from_numpy(np.pad(tokens, ((0, 0), (
            0, -tokens.shape[1] % 16)))).to(dev)
        m_seq = torch.from_numpy(m).to(dev)
        N, L = tok.shape
        out = {k: torch.empty((N, bpm.SIGMA, nblk), dtype=torch.int64,
                              device=dev) for k in ("old", "new")}

        def run(lib, check, key):
            def go():
                check(lib.kt_bpm_table(
                    tok.data_ptr(), L, m_seq.data_ptr(), N, nblk,
                    out[key].data_ptr(), _cuda.stream(dev)), key + " table")
            return go
        run_old = run(old_lib, old.check, "old")
        run_new = run(this_lib, _cuda.check, "new")
        run_old()
        run_new()
        want = bpm.plain_table(tok, m_seq, nblk)
        cs.hold_equal("bpm_table", out["new"], want, f"{label}: new vs plain")
        cs.hold_equal("bpm_table", out["old"], want,
                      f"{label}: parent vs plain")
        b_ms, b_by = cs.bound(int(np.minimum(lens, bpm.WORD * nblk).sum())
                              + N * 4 + want.numel() * 8,
                              want.numel() * bpm.WORD, cs.INT32_OPS_PER_S)
        show("bpm_table", label, f"{N}x{bpm.SIGMA}x{nblk}",
             ab(run_old, run_new, 20), against="parent", bound_ms=b_ms,
             bound_by=b_by)


if __name__ == "__main__":
    sys.exit(main())
