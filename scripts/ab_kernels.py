#!/usr/bin/env python3
"""Time the kernels of this checkout against those of another checkout,
on one NVIDIA GPU, in one process.

    git archive <commit> kalign_tpu_torch | tar -x -C _proof/parent
    python3 scripts/ab_kernels.py --parent _proof/parent
    python3 scripts/ab_kernels.py --variant _proof/variant

--parent: the k-means Lloyd kernel of an earlier checkout, called
through its own C entry point `kt_kmeans_lloyd` as of 9eb9643 (one
256-thread block per (cluster, try), no blocks argument), against this
checkout's (a thread-block cluster per (cluster, try)), at the root split
of chip_smoke.py's large path (16,384 protein sequences x 32 anchors, the
fused entry's form): the two splits must be the same or tie in SSE to
chip_smoke.KMEANS_SSE_RTOL (their float orders differ).

--variant: the other checkout has this one's C interfaces (a variant of
one kernel, say): this checkout's own wrappers launch it, with their
library swapped for the variant's, and its outputs must be identical.
Besides BPM, the match-stream lanewise kernel at the fast path's leaf
bucket, the walk over the decisions of the fast path's largest row
launch (by cells), its lanewise leaf bucket and its widest row launch,
and the fused kernel at the largest launch of each shape the default
path gave it (the inputs of chip_smoke.py's main-shape phase; the two
paths run once here to give their launches).

--parent and --variant may be given together.  Both versions see the
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
    args = ap.parse_args()
    if not (args.parent or args.variant):
        ap.error("give --parent, --variant or both")
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kalign_tpu_torch.core import params as P
    from kalign_tpu_torch.gpu import _cuda, bpm, gotoh_fused, \
        gotoh_lanewise, gotoh_row, kmeans
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
    # -Xptxas -v of each library's Lloyd kernel
    ptxas = {k: cs.ptxas_lines(build_log(m.library_path()), "lloyd_kernel")
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

    def old_lloyd(rows, start, size, form):
        """The earlier checkout's kt_kmeans_lloyd: lloyd's outputs."""
        N, D = rows.shape
        C, T = start.shape[0], kmeans.MAX_TRIES
        score = torch.empty((C, T), dtype=torch.float32, device=dev)
        degen = torch.empty((C, T), dtype=torch.int8, device=dev)
        assign = torch.zeros((T, N), dtype=torch.int8, device=dev)
        iters = torch.empty((C, T), dtype=torch.int32, device=dev)
        rc = old_lib.kt_kmeans_lloyd(
            rows.data_ptr(), D, N, start.data_ptr(), size.data_ptr(), C, T,
            form, kmeans.MAX_ITERS, kmeans.EPS, score.data_ptr(),
            degen.data_ptr(), assign.data_ptr(), iters.data_ptr(),
            _cuda.stream())
        old.check(rc, "earlier lloyd")
        return assign, score, degen, iters

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

    seqs = {"fast": cs.family(2000, seed=0),
            "default": cs.v4_family(2000, seed=2)}

    # the Lloyd kernel at the large path's root split
    if old:
        codes, dm, na = cs.tree_inputs(cs.large_family(), dev)
        n = len(codes)
        emb = torch.from_numpy(np.ascontiguousarray(
            dm[:, :na], np.float32)).to(dev)
        st = torch.zeros(1, dtype=torch.int32, device=dev)
        sz = torch.full((1,), n, dtype=torch.int32, device=dev)
        k_new = lambda: kmeans.lloyd(emb, st, sz, form=1, max_size=n)
        k_old = lambda: old_lloyd(emb, st, sz, 1)
        slot = torch.zeros(n, dtype=torch.int64, device=dev)
        (r_new, _, sse_new), (r_old, _, sse_old) = (
            kmeans.best_tries(*f()[:3], slot) for f in (k_new, k_old))
        differ = int((r_new != r_old).sum())
        sse_new, sse_old = float(sse_new[0]), float(sse_old[0])
        if differ and abs(sse_new - sse_old) > cs.KMEANS_SSE_RTOL * abs(
                sse_old):
            raise AssertionError(f"lloyd: the splits differ ({differ} rows) "
                                 f"and their SSE do not tie: {sse_new} vs "
                                 f"{sse_old}")
        show("kmeans", "root split", f"1 x {kmeans.MAX_TRIES} x {n} x {na}",
             ab(k_old, k_new, 3), rows_differ=differ, sse_new=sse_new,
             sse_old=sse_old,
             iterations_new=k_new()[3].tolist()[0][:40],
             iterations_old=k_old()[3].tolist()[0][:40],
             cluster_blocks=kmeans.cluster_blocks(n),
             ptxas_this=ptxas["this"], ptxas_parent=ptxas["parent"])

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


if __name__ == "__main__":
    sys.exit(main())
