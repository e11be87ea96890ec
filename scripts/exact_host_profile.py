#!/usr/bin/env python3
"""Profile the exact engine's host side on one NVIDIA GPU: the divergent
path of chip_smoke.py (2,000 protein sequences at mean anchor distance
~0.56, default mode) aligned by engine "gpu" under cProfile.

    python3 scripts/exact_host_profile.py [--n 2000] [--top 30]

Prints the card's name and power limit, then one JSON line: the wall,
engine_stats' sweep counts and exact_split_s, and the functions that
took the most host time (their own time, ``tottime``, and with their
callees, ``cumtime``).  cProfile slows the Python side, so the wall here
is longer than an unprofiled run's.
"""

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("exact_host_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import kalign_tpu_torch
    print(cs.nvidia_smi_line(), flush=True)
    seqs = cs.divergent_family(args.n)
    kalign_tpu_torch.align_msa(seqs[:100], mode="default", engine="gpu")
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    msa = kalign_tpu_torch.align_msa(seqs, mode="default", engine="gpu")
    prof.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = []
    for (path, line, fn), (cc, nc, tt, ct, _) in st.stats.items():
        rows.append(dict(fn=f"{os.path.relpath(path, HERE)}:{line}:{fn}"
                         if path.startswith(HERE) else f"{path}:{fn}",
                         calls=nc, tottime=round(tt, 3),
                         cumtime=round(ct, 3)))
    es = msa.engine_stats
    print(json.dumps({
        "sequences": len(seqs), "wall_s": wall,
        **{k: es.get(k) for k in ("engine", "sweep_launches", "sweep_grids",
                                  "sweep_steps", "hook_calls",
                                  "exact_split_s")},
        "by_tottime": sorted(rows, key=lambda r: -r["tottime"])[:args.top],
        "by_cumtime": sorted(rows, key=lambda r: -r["cumtime"])[:args.top]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
