"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m msabench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up (counted in setup_s): import the port, build or load its
libraries (kalign_tpu_torch/_build/, inside the checkout), make the
cell's families from the seed, and align one reduced family of the
cell's own lengths.  The window: distinct families of the cell's shape,
aligned back to back through kalign_tpu_torch.align_msa (a closed loop
with one client); alignments start until S seconds have passed, the
last one finishes.  Then every alignment of the window is judged by
each check that the configuration's ``limits`` name
(msabench/checks/<name>.py: the rows, and the guide tree, the
consistency maps and the match preparation that the alignment's stages
produced, against the family's true homology, reference/homology.py,
and the traffic's consistency weight), and the last line of standard
output is one JSON object; the compared numbers and their limits are
also the last lines of standard error.

With --trace 0 the line holds the cell's end-to-end metrics, with
--trace 1 its per-layer ones, read by msabench/metrics/<name>.py from a
torch.profiler trace of the window (msabench/tracing.py).  Without a
card, or with fewer cards than the cell asks for, the run prints no
result and exits non-zero; so it does when the run loaded JAX,
kalign_tpu or the old benchmark (msabench/guard.py).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from msabench import families, guard, manifest, tracing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# families are k = 0 .. families - 1 of the seed; the warm family is
# this k, so it is none of the window's
WARM_K = 1 << 20


class Run:
    """What one run measured; the metric readers read it.  ``device`` is
    "cuda" or, in the tests' plumbing runs, "cpu" (then no device metric
    is reported)."""

    def __init__(self, cell, config, traffic, seed, seconds, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.setup_s = None
        self.window_s = None
        self.alignments = []        # per alignment: wall, phases, stats
        self.peak_bytes = None
        self.trace = None           # tracing.Trace of a traced run
        self.probes = {}            # metric -> records of its probe
        self.captures = {}          # check -> [(alignment, record)]
        self.k = {"k": None}        # the alignment under way


def align(seqs, traffic, device):
    import kalign_tpu_torch
    return kalign_tpu_torch.align_msa(
        seqs, mode=traffic["mode"], engine=traffic["engine"],
        refine=traffic.get("refine"), autoroute=traffic["autoroute"],
        device=device)


def setup(run: Run):
    """Libraries, the families, one warm alignment; the card drained."""
    import torch
    from kalign_tpu_torch import warmup
    warmup.build_libraries(run.device)
    fams = [families.of_config(run.config, run.seed, k)
            for k in range(run.traffic["families"])]
    warm = families.of_config(run.config, run.seed, WARM_K,
                              run.config["warm_sequences"])
    align(warm[0], run.traffic, run.device)
    if run.device != "cpu":
        torch.cuda.synchronize()
    return fams


def window(run: Run, fams):
    """Align family after family until run.seconds have passed; returns
    each alignment's rows."""
    import torch
    cuda = run.device != "cpu"
    out = []
    t0 = time.perf_counter()
    with torch.profiler.record_function(tracing.WINDOW):
        while not out or time.perf_counter() - t0 < run.seconds:
            if len(out) == len(fams):
                raise RuntimeError(
                    f"the window outran the {len(fams)} families made for "
                    "it: raise the traffic's 'families'")
            run.k["k"] = len(out)
            a0 = time.perf_counter()
            with torch.profiler.record_function("msabench.align"):
                msa = align(fams[len(out)][0], run.traffic, run.device)
                rows = msa.aligned_rows()
            if cuda:
                torch.cuda.synchronize()
            stats = msa.engine_stats
            run.alignments.append({
                "wall_s": time.perf_counter() - a0,
                "phase_times": dict(msa.phase_times),
                "fetches": stats.get("fetches"),
                "engine": stats.get("engine"), "tree": stats.get("tree")})
            out.append(rows)
    run.window_s = time.perf_counter() - t0
    return out


def judge(run: Run, checks: dict, fams, rows_list) -> dict:
    """Each check's value over the window with its limit, and how many
    alignments failed one.  A check's value is its largest over the
    alignments, or, where the check counts (``counts``: what it finds
    wrong and out of how many), the pooled share over the window; a
    pooled share past its limit fails every alignment of the window."""
    limits = run.config["limits"]
    worst = {name: 0.0 for name in checks}
    pooled = {name: [0, 0] for name, mod in checks.items()
              if hasattr(mod, "counts")}
    bad = [False] * len(rows_list)
    for k, rows in enumerate(rows_list):
        ctx = {"seed": [run.seed, k, 1], "config": run.config,
               "traffic": run.traffic}
        for name, mod in checks.items():
            recs = [r for a, r in run.captures.get(name, []) if a == k]
            if name in pooled:
                got = mod.counts(fams[k], rows, recs, ctx)
                pooled[name] = [pooled[name][0] + got[0],
                                pooled[name][1] + got[1]]
                continue
            v = mod.value(fams[k], rows, recs, ctx)
            worst[name] = max(worst[name], v)
            bad[k] |= v > limits[name]
    for name, (wrong, total) in pooled.items():
        worst[name] = wrong / total if total else 1.0
        if worst[name] > limits[name]:
            bad = [True] * len(rows_list)
    return {"failed": sum(bad), "checks": {
        name: {"value": worst[name], "limit": limits[name]}
        for name in checks}}


def power_limit():
    """The card's power limit (W) as nvidia-smi reads it, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(root, workload, seed, seconds, trace, device="cuda",
             t_start=None):
    """One run of a cell; returns the result's dict.  device "cpu" is the
    tests' plumbing run: the same loop and checks on the port's plain
    versions, with the metrics of a device left out.  Set-up is counted
    from t_start (by default this module's import)."""
    import torch
    bench = manifest.Manifest(root)
    cell = bench.workload(workload)
    run = Run(cell, bench.config(cell["config"]),
              bench.traffic(cell["traffic"]), seed, seconds, device)
    entries = bench.metrics(workload, trace)
    readers = {m["name"]: bench.reader(m["name"]) for m in entries}
    checks = {name: bench.check(name) for name in run.config["limits"]}
    fams = setup(run)
    run.setup_s = time.perf_counter() - (T_START if t_start is None
                                         else t_start)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tracing.captures(checks, run.captures, run.k):
        if trace:
            with tracing.hooks(readers, run.probes):
                if cuda:
                    with tracing.Capture() as cap:
                        rows = window(run, fams)
                    run.trace = tracing.Trace.of_events(cap.events())
                else:
                    rows = window(run, fams)
        else:
            rows = window(run, fams)
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    verdict = judge(run, checks, fams, rows)
    metrics = {}
    for m in entries:
        if not cuda and m["source"] == "device_trace":
            continue
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": run.peak_bytes}
    if cuda:
        dev["power_limit_w"] = power_limit()
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = (run.trace.window_s() if run.trace.window
                           else run.window_s)
    out = {"correct": verdict["failed"] == 0,
           "attempted": len(run.alignments), "failed": verdict["failed"],
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["alignments_s"] = [a["wall_s"] for a in run.alignments]
    for k, a in enumerate(run.alignments):
        print(f"alignment {k}: {a['phase_times']}", file=sys.stderr)
    out["checks"] = verdict["checks"]
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed takes a whole number >= 0")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    bench = manifest.Manifest(ROOT)
    chips = bench.workload(args.workload)["chips"]
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"msabench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = guard.forbidden_loaded()
    if bad:
        print(f"msabench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, wall in enumerate(out["alignments_s"]):
        print(f"alignment {k}: {wall!r} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
