#!/usr/bin/env python3
"""Where chip_smoke.py spends its wall time, by function.

    python3 scripts/phase_sampler.py --out chiprun_out/samples.json \
        [--period 0.5] -- [chip_smoke.py arguments]

Runs chip_smoke.main in this process while a thread reads the main
thread's stack every --period seconds.  Each sample is charged to its
chain of chip_smoke.py frames (outermost first) and to the innermost frame
of the repository below them ("chain | file:function"); the file gets
the seconds of every chain and of every chip_smoke.py function
(inclusive), largest first, and the top lines go to standard error.  The
sampler costs one stack walk per period.  The exit code is
chip_smoke.py's."""

import argparse
import collections
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(HERE, "chip_smoke.py")


def sample_key(frame):
    """"chain of chip_smoke.py functions | innermost repository frame"."""
    chain, inner = [], None
    f = frame
    while f is not None:
        name = f.f_code.co_filename
        path = os.path.abspath(name) if not name.startswith("<") else name
        if path == SMOKE:
            chain.append(f.f_code.co_name)
        elif (inner is None and path.startswith(HERE + os.sep)
              and path != os.path.abspath(__file__)):
            inner = (f"{os.path.relpath(path, HERE)}:"
                     f"{f.f_code.co_name}")
        f = f.f_back
    return f"{'>'.join(reversed(chain))} | {inner or '-'}"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--period", type=float, default=0.5)
    parser.add_argument("rest", nargs=argparse.REMAINDER)
    args = parser.parse_args()
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    sys.path.insert(0, HERE)
    import chip_smoke

    main_id = threading.get_ident()
    chains = collections.Counter()
    stop = threading.Event()

    def sampler():
        last = time.perf_counter()
        while not stop.wait(args.period):
            now = time.perf_counter()
            # no frame outlives the walk: a frame held from one sample to
            # the next would keep its locals (tensors on the card) alive
            key = sample_key(sys._current_frames().get(main_id))
            chains[key] += now - last
            last = now

    thread = threading.Thread(target=sampler, daemon=True)
    thread.start()
    try:
        rc = chip_smoke.main(rest)
    finally:
        stop.set()
        thread.join()
        by_fn = collections.Counter()
        for key, s in chains.items():
            for fn in set(key.split(" | ")[0].split(">")):
                by_fn[fn] += s
        out = {"chains": dict(chains.most_common()),
               "functions": dict(by_fn.most_common())}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        for key, s in chains.most_common(40):
            print(f"sampled {s:8.1f} s  {key}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
