"""Device-side timing from a profiler trace.

A host clock around an alignment measures the host's wall, of which the
card may be idle most of the time.  The card's own busy time is the sum
of the events the profiler attributes to the device's process in the
exported Chrome-trace files.  Counterpart of kalign_tpu/utils/devtime.py:
``device_seconds`` is its parser (intervals merged per (pid, tid), so
nested or overlapping events of one stream count once, and two streams
at work at once twice); ``busy_seconds`` takes the union over a device
process's streams, the card's busy time.  ``trace`` traces with
``torch.profiler`` (CPU and CUDA activities) in place of
``jax.profiler.trace``, writing through
``torch.profiler.tensorboard_trace_handler``, whose ``*.pt.trace.json``
files ``_iter_trace_files`` finds; the CLI's ``--trace`` writes such a
trace, in which the program's spans are ranges (utils/logging.py).

Kineto gives a CUDA device's process the host process's name and the
label "GPU <index>" (``process_labels``); jax.profiler names the device's
process itself ("/device:TPU:0").  A process is the device's when either
holds ``device_substr`` (default ``DEVICE``).
"""

import glob
import gzip
import json
import os
from contextlib import contextmanager

DEVICE = "GPU"
# the process metadata events that name a process, and their argument
_PROCESS_META = {"process_name": "name", "process_labels": "labels"}
# device events that are spans of host ranges, not work
_NOT_WORK = ("gpu_user_annotation",)


def _iter_trace_files(trace_dir):
    pats = [
        os.path.join(trace_dir, "**", "*.trace.json.gz"),
        os.path.join(trace_dir, "**", "*.trace.json"),
    ]
    seen = set()
    for p in pats:
        for f in glob.glob(p, recursive=True):
            if f not in seen:
                seen.add(f)
                yield f


def _device_intervals(trace_dir, device_substr):
    """Per Chrome-trace file under trace_dir, the complete events of its
    device processes (those whose process_name or process_labels
    metadata holds device_substr) as {(pid, tid): [(start, end)]} in
    microseconds, Kineto's gpu_user_annotation events (a record_function
    range drawn on the device from its first kernel's start to its last
    one's end, idle gaps included: not device work) left out.  A file
    that is not JSON is skipped."""
    for path in _iter_trace_files(trace_dir):
        opener = gzip.open if path.endswith(".gz") else open
        try:
            with opener(path, "rb") as fh:
                data = json.load(fh)
        except (OSError, EOFError, ValueError):
            continue
        events = data.get("traceEvents", [])
        dev_pids = set()
        for e in events:
            if e.get("ph") == "M" and e.get("name") in _PROCESS_META:
                name = str((e.get("args") or {}).get(
                    _PROCESS_META[e["name"]], ""))
                if device_substr in name:
                    dev_pids.add(e.get("pid"))
        by_thread = {}
        for e in events:
            if e.get("ph") == "X" and e.get("pid") in dev_pids \
                    and e.get("cat") not in _NOT_WORK:
                ts = e.get("ts")
                dur = e.get("dur")
                if ts is None or dur is None:
                    continue
                by_thread.setdefault((e["pid"], e.get("tid")), []).append(
                    (float(ts), float(ts) + float(dur)))
        yield by_thread


def _merged(ivals):
    """The union of [(start, end)] intervals as disjoint intervals, in
    order."""
    cur_s, cur_e = None, None
    for s, t in sorted(ivals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                yield cur_s, cur_e
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        yield cur_s, cur_e


def device_seconds(trace_dir, device_substr=DEVICE):
    """Sum event durations (seconds) attributed to device processes in
    every Chrome-trace file under `trace_dir` (kalign_tpu's measure).

    Events nested inside other events on the same thread would
    double-count, so the complete events of each (pid, tid) are merged
    into intervals before they are summed; a stream is a thread of the
    device's process, so two streams at work at once count twice (see
    busy_seconds)."""
    total = 0.0
    for by_thread in _device_intervals(trace_dir, device_substr):
        for ivals in by_thread.values():
            for s, t in _merged(ivals):
                total += t - s
    return total / 1e6  # trace timestamps are microseconds


def busy_seconds(trace_dir, device_substr=DEVICE):
    """Seconds in which a device process has work on any of its streams:
    the union of its events over all its threads, summed over the device
    processes of every file under `trace_dir`.  Two streams at work at
    once count once, as msabench/tracing.py's Trace.busy takes a card's
    busy time."""
    total = 0.0
    for by_thread in _device_intervals(trace_dir, device_substr):
        by_pid = {}
        for (pid, _), ivals in by_thread.items():
            by_pid.setdefault(pid, []).extend(ivals)
        for ivals in by_pid.values():
            for s, t in _merged(ivals):
                total += t - s
    return total / 1e6


@contextmanager
def trace(trace_dir):
    """torch.profiler over the enclosed block, its Chrome trace written
    into trace_dir when the block ends: CPU activity, and CUDA activity
    when a card is there (the card drained before the trace closes)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()
