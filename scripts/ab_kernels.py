#!/usr/bin/env python3
"""Time the row Gotoh kernel and the prefix-sum kernel of this checkout
against those of an earlier checkout, on one NVIDIA GPU, in one process.

    git archive <commit> | tar -x -C _proof/parent
    python3 scripts/ab_kernels.py --parent _proof/parent

The earlier checkout's CUDA library is built from its own csrc/ (as
chip_smoke.py builds this one's) and called through its own C entry
points: `kt_gotoh_row_forward` without a block size and
`kt_prefix_sum_f32` on one tensor, the interfaces up to the redesign of
both kernels.  The inputs are those of chip_smoke.py's main-shape phase:
the fast and default paths run once here to give their launches, and the
row kernel is taken at the fast path's largest launch (by cells), its
widest, and the default path's largest launch of few problems; the
prefix sums at the fast path's leaf bucket ([1024, 384], a strided view)
and at the widest row launch's [B, L2p].  Both versions see the same
tensors, their outputs are held bitwise equal, and each is timed in
turns (earlier, this, this, earlier): CUDA events over back-to-back
launches (`ms`, the host's launch time included) and torch.profiler's
device time (`device_ms`).  Prints one JSON line per shape.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_parent_cuda(parent):
    """The earlier checkout's gpu/_cuda.py as a module of its own."""
    path = os.path.join(parent, "kalign_tpu_torch", "gpu", "_cuda.py")
    spec = importlib.util.spec_from_file_location("parent_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked checkout of the earlier commit")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kalign_tpu_torch.gpu import gotoh_row, scan
    from kalign_tpu_torch.gpu import _cuda

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    old = load_parent_cuda(os.path.abspath(args.parent))
    old_lib = old.lib()
    _cuda.lib()

    def old_row(match, prep, la, lb):
        B, L1p, W = match.shape
        dec = torch.empty((B, L1p, W), dtype=torch.int8, device=dev)
        score = torch.empty(B, dtype=torch.float32, device=dev)
        state = torch.empty(B, dtype=torch.int32, device=dev)
        rc = old_lib.kt_gotoh_row_forward(
            match.data_ptr(), *(prep[k].data_ptr() for k in (
                "colpen", "ga0", "rowpen", "cols_eps", "row_term")),
            la.data_ptr(), lb.data_ptr(), B, L1p, W, dec.data_ptr(),
            score.data_ptr(), state.data_ptr(), _cuda.stream())
        old.check(rc, "earlier gotoh_row")
        return dec, score, state

    def old_scan(x):
        R, W = x.shape
        out = torch.empty((R, W), dtype=torch.float32, device=dev)
        rc = old_lib.kt_prefix_sum_f32(x.data_ptr(), x.stride(0), R, W,
                                       out.data_ptr(), _cuda.stream())
        old.check(rc, "earlier prefix_sum")
        return out

    def ab(fn_old, fn_new, reps, name):
        t = {"old_ms": [], "new_ms": [], "old_device_ms": [],
             "new_device_ms": []}
        for which, fn in (("old", fn_old), ("new", fn_new), ("new", fn_new),
                          ("old", fn_old)):
            t[f"{which}_ms"].append(cs.cuda_time_ms(fn, reps=reps))
            t[f"{which}_device_ms"].append(cs.device_ms(fn, reps, name))
        return t

    stats = {p: cs.phase_path(p, s)[1] for p, s in (
        ("fast", cs.family(2000, seed=0)),
        ("default", cs.v4_family(2000, seed=2)))}
    rng = np.random.default_rng(1)

    def cells(b):
        return int(np.sum(b["la"].astype(np.int64) * b["lb"]))

    def row_batch(st, key):
        return max((b for b in st["batches"] if b["route"] == "row"),
                   key=key)

    widest = None
    for label, b in (
            ("largest", row_batch(stats["fast"], cells)),
            ("widest", row_batch(stats["fast"],
                                 lambda b: (b["L2p"], b["L1p"]))),
            ("few", row_batch(stats["default"],
                              lambda b: (-len(b["la"]), cells(b))))):
        p = cs.dp_problem(rng, b["L1p"], b["L2p"], b["la"], b["lb"], dev)
        if label == "widest":
            widest = p
        prep = gotoh_row.prepare(p["pc"], p["pr"], p["la"], p["lb"],
                                 p["slope"], p["eps"])
        a = (p["match"], prep, p["la"], p["lb"])
        cs.hold_dp_outputs("gotoh_row", False, old_row(*a),
                           gotoh_row.launch(*a), p, f"{label} old vs new")
        t = ab(lambda: old_row(*a), lambda: gotoh_row.launch(*a), 10,
               cs.PROFILE_NAMES["gotoh_row"])
        print(json.dumps({"kernel": "gotoh_row", "launch": label,
                          "shape": cs.shape_of(p),
                          "block": gotoh_row.launch_config(
                              len(p["la"]), p["L2p"])._asdict(), **t}),
              flush=True)

    leaf = max((b for b in stats["fast"]["batches"]
                if b["route"] == "lanewise"), key=cells)
    q = cs.dp_problem(rng, leaf["L1p"], leaf["L2p"], leaf["la"], leaf["lb"],
                      dev)
    for label, x in (("leaf", q["pr"][:, 2, 1:]),
                     ("widest", widest["pc"][:, 1, 1:])):
        cs.hold_equal("prefix_sum", old_scan(x), scan.launch(x)[0],
                      f"{label} old vs new")
        t = ab(lambda: old_scan(x), lambda: scan.launch(x), 50,
               cs.PROFILE_NAMES["prefix_sum"])
        t["cumsum_ms"] = cs.cuda_time_ms(lambda: torch.cumsum(x, dim=1), 50)
        t["cumsum_device_ms"] = cs.device_ms(lambda: torch.cumsum(x, dim=1),
                                             50)
        print(json.dumps({"kernel": "prefix_sum", "launch": label,
                          "shape": f"{x.shape[0]}x{x.shape[1]}", **t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
