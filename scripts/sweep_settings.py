#!/usr/bin/env python3
"""Time the exact engine's sweep kernel over the divergent path's
consistency pre-pass at several packings and block sizes, on one NVIDIA
GPU, in one process.

    python3 scripts/sweep_settings.py [--budgets 4096,1024,512,256]
                                      [--threads 256,128] [--rows 1,2,4]

Input: the first slice of chip_smoke.py's divergent path's pre-pass
(chip_smoke.divergent_prepass_pairs: 2,048 residue pairs of 2,000
protein sequences at mean anchor distance ~0.56).  For each packing
budget (exact.PACK_BUDGET["cuda"], the rows of a grid; exact.LAUNCH_CELLS
bounds the grids a launch takes) and each block (exact_sweep.THREADS, and
exact_sweep.ROWS: rows a thread; a setting whose blocks repeat an
earlier one's at its budget is skipped): the pairs' whole recursion
through ExactPairBatch
once untimed and synchronised (``wall_s``: the host's work included),
then once more with every sweep launch timed as it comes
(chip_smoke.device_ms: launches queued behind a spin kernel) and the
times added (``sweep_device_ms``).  The largest launch of each setting
(by cells) is held bitwise against the plain version; every setting must
give the same paths.  Prints one JSON line per setting, after the card's
name and power limit.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budgets", default="4096,1024,512,256")
    ap.add_argument("--threads", default="256,128")
    ap.add_argument("--rows", default="1,2,4")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_settings: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kalign_tpu_torch.gpu import exact as X
    from kalign_tpu_torch.gpu import exact_sweep as XS

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    prepass = cs.divergent_prepass_pairs()
    pairs, subm, gpo, gpe, tgpe = prepass

    def recursion(budget):
        saved = X.PACK_BUDGET["cuda"]
        X.PACK_BUDGET["cuda"] = budget
        try:
            batch = X.ExactPairBatch(pairs, subm, gpo, gpe, tgpe,
                                     X.Sweeper(dev))
            paths = [np.full(len(a) + 2, -1, np.int32) for a, _ in pairs]
            batch.run(paths)
        finally:
            X.PACK_BUDGET["cuda"] = saved
        return batch, paths

    defaults = XS.THREADS, XS.ROWS
    want, done = None, set()
    settings = [(t, r, b) for t in map(int, args.threads.split(","))
                for r in map(int, args.rows.split(","))
                for b in map(int, args.budgets.split(","))]
    for threads, rows, budget in settings:
        XS.THREADS, XS.ROWS = threads, rows
        if (budget, XS.launch_plan(budget)) in done:
            continue
        done.add((budget, XS.launch_plan(budget)))
        recursion(budget)                       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, paths = recursion(budget)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if want is None:
            want = paths
        same = all(np.array_equal(a, b) for a, b in zip(want, paths))
        rec = dict(ms=[], grids=[], steps=[], cells=[])
        largest = {}

        def keep(plans, key, live, kind):
            VR, C, Wmax, chain = key
            lp = XS.launch_plan(VR)
            _, span = XS.schedule(plans, live[1], lp.threads * lp.rows)
            t = cs.sweep_tensors(plans, key, live, dev)
            run = lambda: XS.launch(t, VR, C, Wmax, chain, *live)
            rec["ms"].append(cs.device_ms(run, 3))
            rec["grids"].append(int(plans["seedA"].shape[0]))
            rec["steps"].append(XS.steps_run(span))
            cells = cs.sweep_cells(plans, live)
            rec["cells"].append(cells)
            if cells > largest.get("cells", -1):
                largest.update(cells=cells, launch=(plans, key, live))
        with cs.sweep_capture(keep):
            recursion(budget)
        big, _ = cs.hold_sweep(*largest["launch"],
                               f"pre-pass at {budget} rows, {threads} "
                               "threads: largest launch", dev)
        lp = XS.launch_plan(big["VR"])
        print(json.dumps({
            "budget": budget, "threads": threads, "rows": rows,
            "pairs": len(pairs),
            "VR": batch.VR, "plan": lp._asdict(),
            "launches": len(rec["ms"]),
            "blocks_min": min(rec["grids"]),
            "blocks_max": max(rec["grids"]),
            "sweep_device_ms": sum(rec["ms"]),
            "largest": dict(shape=f"{big['grids']} x {big['VR']} x "
                            f"{big['C'] + 1}", cells=big["cells"],
                            device_ms=rec["ms"][rec["cells"].index(
                                big["cells"])]),
            "steps_max": max(rec["steps"]), "wall_s": wall,
            "paths_equal": same}), flush=True)
        if not same:
            raise AssertionError(f"sweep_settings: budget {budget}, "
                                 f"{threads} threads gave other paths")
    XS.THREADS, XS.ROWS = defaults
    return 0


if __name__ == "__main__":
    sys.exit(main())
