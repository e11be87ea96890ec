#!/usr/bin/env python3
"""Time the kernels of this checkout against those of another checkout,
on one NVIDIA GPU, in one process.

    git archive <commit> kalign_tpu_torch | tar -x -C _proof/parent
    python3 scripts/ab_kernels.py --parent _proof/parent
    python3 scripts/ab_kernels.py --variant _proof/variant

--parent: the exact engine's wavefront sweep of an earlier checkout,
called through its own C entry point `kt_exact_sweep` as of a0624b2 (one
block per grid on the reference's schedule, VR + C + 1 steps; 16 rows a
thread past 256 rows, 1,024 threads with a global scratch past 4,096),
against this checkout's (the band-local schedule), on the divergent
path's largest sweep launch of that commit: the pre-pass's pairs packed
into 64 grids of 4,096 rows (chip_smoke.prepass_plan).  The two outputs
must be bitwise equal.

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
    from kalign_tpu_torch.gpu import _cuda, bpm, exact_sweep, gotoh_fused, \
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
    # -Xptxas -v of each library's sweep kernel
    ptxas = {k: cs.ptxas_lines(build_log(m.library_path()),
                               "exact_sweep")
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

    def old_sweep(t, key, live):
        """The earlier checkout's kt_exact_sweep on the plan t: out."""
        VR, C, _, chain = key
        W, ncols = live
        G = t["seedA"].shape[0]
        rowi, rowf, cols, p2sub = exact_sweep.operands(t, VR, C, chain)
        threads = min(VR, 256) if VR <= 4096 else 1024
        out = torch.full((G, W, ncols, 3), float("-inf"), device=dev)
        scratch = (torch.empty((G, 6, VR), device=dev) if threads == 1024
                   else None)
        rc = old_lib.kt_exact_sweep(
            rowi.data_ptr(), rowf.data_ptr(), cols.data_ptr(),
            t["match"].data_ptr(), t["bonus"].data_ptr(),
            t["p1cnt"].data_ptr(), p2sub.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), G, VR, C,
            t["match"].shape[-1], W, ncols,
            exact_sweep.live_steps(VR, C, ncols), int(chain), threads,
            VR // threads, _cuda.stream())
        old.check(rc, "earlier exact_sweep")
        return out

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

    # the sweep at the divergent path's largest launch of the parent
    if old:
        plans, key, live = cs.prepass_plan(cs.divergent_prepass_pairs(), dev)
        VR, C, Wmax, chain = key
        t = cs.sweep_tensors(plans, key, live, dev)
        s_new = lambda: exact_sweep.launch(t, VR, C, Wmax, chain, *live)
        s_old = lambda: old_sweep(t, key, live)
        cs.hold_equal("exact_sweep", s_old().view(torch.int32),
                      s_new().view(torch.int32), "parent vs new, bitwise")
        lp = exact_sweep.launch_plan(VR)
        _, span = exact_sweep.schedule(plans, live[1],
                                       lp.threads * lp.rows)
        G = int(plans["seedA"].shape[0])
        show("exact_sweep", "pre-pass, packed to 4,096 rows",
             f"{G} x {VR} x {C + 1}", ab(s_old, s_new, 3),
             cells=cs.sweep_cells(plans, live), live=list(live),
             steps_new=exact_sweep.steps_run(span),
             steps_old=exact_sweep.live_steps(VR, C, live[1]),
             plan_new=lp._asdict(), ptxas_this=ptxas["this"],
             ptxas_parent=ptxas["parent"])

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
