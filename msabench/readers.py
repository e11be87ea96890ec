"""Helpers the metric readers (msabench/metrics/<name>.py) share."""

import os

from msabench import counts


def name_of(path: str) -> str:
    """A reader's metric name: its file's stem."""
    return os.path.splitext(os.path.basename(path))[0]


def phase_mean(run, phase: str):
    """Mean seconds per alignment of one of msa.phase_times' phases, or
    None where no alignment ran it."""
    vals = [a["phase_times"][phase] for a in run.alignments
            if phase in a["phase_times"]]
    return sum(vals) / len(vals) if vals else None


def host(t, cache: dict):
    """A device tensor's values on the host, fetched once per tensor."""
    key = id(t)
    if key not in cache:
        cache[key] = (t, t.cpu().tolist())
    return cache[key][1]


def roofline(run, metric: str, kernel: str, problems):
    """Percent of the kernel's least time (counts.least_seconds of its
    launches) over its device time in the trace; None where the run
    recorded no launch or the trace holds none of the kernel's time.
    problems(record, cache) gives a probe record's [(rows, cols)]."""
    records = run.probes.get(metric) or []
    if run.trace is None or not records:
        return None
    cache = {}
    least = counts.least_seconds(problems(r, cache) for r in records)
    spent = run.trace.kernel_s(kernel)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
