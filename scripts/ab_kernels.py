#!/usr/bin/env python3
"""Time the traceback walk and the lanewise Gotoh kernel (its fused and
match-stream instantiations) of this checkout against those of an
earlier checkout, on one NVIDIA GPU, in one process.

    git archive <commit> kalign_tpu_torch | tar -x -C _proof/parent
    python3 scripts/ab_kernels.py --parent _proof/parent
    python3 scripts/ab_kernels.py --variant _proof/variant

With --variant, the other checkout has this one's C interfaces (a
variant of one kernel, say): this checkout's own wrappers launch it,
with their library swapped for the variant's, and its outputs must be
identical.  --parent and --variant may be given together.

The earlier checkout's CUDA library is built from its own csrc/ (as
chip_smoke.py builds this one's) and called through its own C entry
points: `kt_traceback` without a launch plan, `kt_gotoh_lanewise_forward`
and `kt_gotoh_fused_forward` with a device-memory strip boundary, the
interfaces up to the redesign of both kernels, whose nibble decisions
are laid out [L1p, L2p/8, B] (this checkout's: [B, L2p/8, L1p4]; the
lanewise walks are given the same cells in each one's layout).  The
inputs are those of chip_smoke.py's main-shape phase: the fast and
default paths run once here to give their launches; the walk is taken
over the decisions of the fast path's largest row launch (by cells), its
lanewise leaf bucket and its widest row launch, each layout timed on its
own; the fused kernel at the largest launch of each shape the default
path gave it; the match-stream kernel at the fast path's leaf bucket.  Both versions see
the same tensors, their outputs are held bitwise equal, and each is
timed in turns (earlier, this, this, earlier): CUDA events over
back-to-back launches (`ms`, the host's launch time included) and
chip_smoke.device_ms (`device_ms`, the launches queued behind a spin
kernel, so the host's launch time is hidden).  Prints one JSON line per
shape.
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
    from kalign_tpu_torch.gpu import _cuda, gotoh_fused, gotoh_lanewise, \
        gotoh_row
    from kalign_tpu_torch.gpu import traceback as tb
    from kalign_tpu_torch.gpu.engine import leaf_operands

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    old = var = None
    if args.parent:
        old = load_cuda(os.path.abspath(args.parent), "parent_cuda")
        old_lib = old.lib()
    if args.variant:
        var = load_cuda(os.path.abspath(args.variant), "variant_cuda")
        var.lib()
    _cuda.lib()

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

    def old_walk(lanewise, dec, la, lb, st, max_steps, L1p, L2p):
        B = la.shape[0]
        steps = torch.empty((B, max_steps), dtype=torch.int8, device=dev)
        n = torch.empty(B, dtype=torch.int32, device=dev)
        rc = old_lib.kt_traceback(
            int(lanewise), dec.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), B, L1p, L2p, max_steps, steps.data_ptr(),
            n.data_ptr(), _cuda.stream())
        old.check(rc, "earlier traceback")
        return steps, n

    def old_dp(entry, lead, B, L1p, L2p, prep, la, lb):
        bound = torch.empty((B, 3, L2p), dtype=torch.float32, device=dev)
        dec = torch.empty((L1p, L2p // 8, B), dtype=torch.int32, device=dev)
        score = torch.empty(B, dtype=torch.float32, device=dev)
        state = torch.empty(B, dtype=torch.int32, device=dev)
        rc = getattr(old_lib, entry)(
            *lead, *(prep[k].data_ptr() for k in (
                "colpen", "cols_eps", "rowpen", "row_term", "gb0", "ga0")),
            la.data_ptr(), lb.data_ptr(), B, L1p, L2p, bound.data_ptr(),
            dec.data_ptr(), score.data_ptr(), state.data_ptr(),
            _cuda.stream())
        old.check(rc, f"earlier {entry}")
        return dec, score, state

    def new_layout(dec):
        """[L1p, W8, B] nibble words -> [B, W8, L1p4]."""
        d = dec.permute(2, 1, 0)
        return gotoh_lanewise.pack_dec(
            gotoh_lanewise.unpack_dec(d, d.shape[1] * gotoh_lanewise.PACK))

    def old_layout(dec, L1p):
        return dec[:, :, :L1p].permute(2, 1, 0).contiguous()

    def ab(fn_old, fn_new, reps, other="old"):
        t = {f"{other}_ms": [], "new_ms": [], f"{other}_device_ms": [],
             "new_device_ms": []}
        for which, fn in ((other, fn_old), ("new", fn_new), ("new", fn_new),
                          (other, fn_old)):
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

    stats = {p: cs.phase_path(p, s)[1] for p, s in (
        ("fast", cs.family(2000, seed=0)),
        ("default", cs.v4_family(2000, seed=2)))}
    rng = np.random.default_rng(1)

    def cells(b):
        return int(np.sum(b["la"].astype(np.int64) * b["lb"]))

    def largest(st, route, key=cells):
        return max((b for b in st["batches"] if b["route"] == route),
                   key=key)

    def problem(b):
        return cs.dp_problem(rng, b["L1p"], b["L2p"], b["la"], b["lb"], dev)

    # the match-stream lanewise kernel and its walk at the leaf bucket
    q = problem(largest(stats["fast"], "lanewise"))
    prep = gotoh_lanewise.prepare(q["pc"], q["pr"], q["la"], q["lb"],
                                  q["slope"], q["eps"])
    B, L1p, L2p = len(q["la"]), q["L1p"], q["L2p"]

    def same_dp(name, p):
        return lambda a, b: cs.hold_dp_outputs(name, True, a, b, p,
                                               "variant vs new")
    a_new = lambda: gotoh_lanewise.launch(q["match"], prep, q["la"], q["lb"])
    lw_out = a_new()
    if old:
        a_old = lambda: old_dp("kt_gotoh_lanewise_forward",
                               (q["match"].data_ptr(),), B, L1p, L2p, prep,
                               q["la"], q["lb"])
        old_out = a_old()
        cs.hold_dp_outputs("gotoh_lanewise", True,
                           (new_layout(old_out[0]), *old_out[1:]), lw_out, q,
                           "leaf old vs new")
        show("gotoh_lanewise", "leaf", cs.shape_of(q),
             ab(a_old, a_new, 10))
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
        extra = dict(layout="lanewise" if lanewise else "rows",
                     plan=tb.launch_plan(len(p["la"]), wa[4])._asdict())
        if old:
            wo = ((old_layout(dec, p["L1p"]) if lanewise else dec), *wa[1:])
            w_old = lambda: old_walk(lanewise, *wo, p["L1p"], p["L2p"])
            cs.hold_walks(w_old(), w_new(), p["la"], p["lb"],
                          f"{label} old vs new")
            show("traceback", label, cs.shape_of(p),
                 ab(w_old, w_new, 20), **extra)
        against_variant(
            "traceback", label, cs.shape_of(p), w_new, 20,
            lambda a, b: cs.hold_walks(a, b, p["la"], p["lb"],
                                       f"{label} variant vs new"), **extra)

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
        shape = f"{B}x{L1p}x{L2p}"
        f = dict(la=la, lb=lb, L2p=L2p)
        plan = gotoh_lanewise.launch_plan(L2p, nc)._asdict()
        if old:
            f_old = lambda: old_dp("kt_gotoh_fused_forward",
                                   (x.data_ptr(), y.data_ptr(), nc), B, L1p,
                                   L2p, fprep, la, lb)
            old_out = f_old()
            cs.hold_dp_outputs("gotoh_fused", True,
                               (new_layout(old_out[0]), *old_out[1:]),
                               f_new(), f, f"{shape} old vs new")
            show("gotoh_fused", "map DPs", shape,
                 ab(f_old, f_new, 10), plan=plan)
        against_variant("gotoh_fused", "map DPs", shape, f_new, 10,
                        same_dp("gotoh_fused", f), plan=plan)
    return 0


if __name__ == "__main__":
    sys.exit(main())
