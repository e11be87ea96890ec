"""The traced run: hooks around the program's calls, the profiler's
window, and what the trace says.

Hooks (installed only with --trace 1): a metric's reader may name a
host range (``RANGE = "module:Attr.path"``: the call runs under a
torch.profiler range of the metric's layer) and a probe (``PROBE =
("module:Attr.path", record)``: record(args, kwargs) is kept for the
reader before each call).  The program's own ``progressive.<part>``
ranges are in the trace already.

The trace is read from torch.profiler's Kineto events: device work is
every kernel, copy and memset on any stream of the card (every device
event but the ranges drawn over kernels); busy time is
their union over streams, so two streams at work count once.  Idle gaps
(the window less the union) are named by the innermost host range open
on the main thread at the gap's middle.
"""

import bisect
import functools
import importlib
import time
from contextlib import contextmanager

# seconds of idle time at each end of the capture: on the card's
# machine the profiler has dropped records near the ends of a window
# (chip_smoke.py's PROFILE_PAD_S)
PAD_S = 2.0
# host ranges (record_function) by name: the harness's, the layers' and
# the program's; on the card an event of such a name is the range drawn
# over its kernels, not work (Kineto's gpu_user_annotation)
RANGES = ("msabench.", "layer.", "progressive.")
WINDOW = "msabench.window"
TOP = 10


def _resolve(target: str):
    """(owner, attribute name) of "module:Attr.path"."""
    mod, path = target.split(":")
    owner = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def _wrap(owner, name, around):
    """Replace owner.name by a wrapper; around(fn) gives it.  Static and
    class methods keep their kind.  Returns the undo."""
    raw = owner.__dict__[name] if name in vars(owner) else getattr(owner,
                                                                   name)
    if isinstance(raw, (staticmethod, classmethod)):
        new = type(raw)(around(raw.__func__))
    else:
        new = around(raw)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, raw)


def ranged(label: str):
    def around(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            import torch
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return call
    return around


def probed(record, into: list):
    def around(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            into.append(record(a, k))
            return fn(*a, **k)
        return call
    return around


def around_call(fn, into: list, where: dict, keep_last: bool):
    """fn(call, args, kwargs) -> (result, record) in the call's place;
    the record is kept in ``into`` with the alignment it belongs to
    (where["k"]), or, with keep_last, in place of that alignment's
    previous record."""
    def around(call):
        @functools.wraps(call)
        def wrapped(*a, **k):
            out, rec = fn(call, a, k)
            if keep_last and into and into[-1][0] == where["k"]:
                into[-1] = (where["k"], rec)
            else:
                into.append((where["k"], rec))
            return out
        return wrapped
    return around


@contextmanager
def captures(checks: dict, into: dict, where: dict):
    """Install the checks' captures: a check module may name calls of
    the program (``AROUND = [("module:Attr.path", fn), ...]``, fn as
    around_call takes it; ``KEEP_LAST = True`` keeps one record an
    alignment); each check's records go to into[check]."""
    undo = []
    try:
        for name, mod in checks.items():
            arounds = getattr(mod, "AROUND", ())
            if arounds:
                into[name] = []
            for target, fn in arounds:
                undo.append(_wrap(*_resolve(target), around_call(
                    fn, into[name], where, getattr(mod, "KEEP_LAST",
                                                   False))))
        yield
    finally:
        for u in reversed(undo):
            u()


@contextmanager
def hooks(readers: dict, probes: dict):
    """Install the readers' ranges and probes ({metric: reader}); each
    probe's records go to probes[metric]."""
    undo = []
    try:
        for metric, mod in readers.items():
            rng = getattr(mod, "RANGE", None)
            if rng:
                undo.append(_wrap(*_resolve(rng), ranged(
                    "layer." + getattr(mod, "LAYER", metric))))
            probe = getattr(mod, "PROBE", None)
            if probe:
                probes[metric] = []
                undo.append(_wrap(*_resolve(probe[0]),
                                  probed(probe[1], probes[metric])))
        yield
    finally:
        for u in reversed(undo):
            u()


class Capture:
    """torch.profiler (CPU and CUDA) around a block, padded by PAD_S
    idle seconds at each end, the card drained before and after."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(PAD_S)
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        self.prof.stop()
        return False

    def events(self):
        return self.prof.profiler.kineto_results.events()


class Trace:
    """What a trace holds: device work [(start, end, name, stream)],
    host ranges [(start, end, name)] of the main thread, the window
    (start, end), in ns of the trace's clock."""

    def __init__(self, work, ranges, window):
        self.work = work
        self.ranges = ranges
        self.window = window

    @classmethod
    def of_events(cls, events):
        from torch.autograd import DeviceType
        work, ann = [], []
        window, main = None, None
        for e in events:
            name = e.name()
            is_range = name.startswith(RANGES)
            if e.device_type() == DeviceType.CUDA:
                if not is_range and e.duration_ns() > 0:
                    s = e.start_ns()
                    work.append((s, s + e.duration_ns(), name,
                                 e.device_resource_id()))
            elif is_range:
                s = e.start_ns()
                ann.append((s, s + e.duration_ns(), name,
                            e.start_thread_id()))
                if name == WINDOW:
                    window, main = (s, s + e.duration_ns()), \
                        e.start_thread_id()
        ranges = [(s, t, n) for s, t, n, th in ann
                  if th == main and n != WINDOW]
        return cls(work, ranges, window)

    # --------------------------------------------------------------
    def busy(self):
        """The union of device work over streams: merged [(start, end)]."""
        out = []
        for s, t, _, _ in sorted(self.work):
            if out and s <= out[-1][1]:
                if t > out[-1][1]:
                    out[-1][1] = t
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernel_s(self, substr: str) -> float:
        """Summed time of the kernels whose name holds substr."""
        return sum(t - s for s, t, n, _ in self.work if substr in n) / 1e9

    def device_ops(self, top: int = TOP):
        """[[name, seconds]] of the device operations with most time."""
        by = {}
        for s, t, n, _ in self.work:
            by[n] = by.get(n, 0) + (t - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], ns / 1e9] for n, ns in rows]

    def gaps(self):
        """[(start, end)] where no device work runs within the window."""
        if self.window is None:
            return []
        w0, w1 = self.window
        out, cur = [], w0
        for s, t in self.busy():
            if t <= w0:
                continue
            if s >= w1:
                break
            if s > cur:
                out.append((cur, s))
            cur = max(cur, t)
        if cur < w1:
            out.append((cur, w1))
        return out

    def segments(self):
        """The innermost host range over time: sorted [(start, name)]
        (None where no range is open)."""
        marks = []
        for i, (s, t, n) in enumerate(self.ranges):
            marks.append((s, 1, i))
            marks.append((t, 0, i))
        marks.sort()
        stack, segs = [], []
        for time_ns, opening, i in marks:
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            segs.append((time_ns, self.ranges[stack[-1]][2]
                         if stack else None))
        return segs

    def idle_gaps(self, top: int = TOP):
        """[[host range, seconds]]: the idle time within the window by
        the innermost host range open at each gap's middle."""
        segs = self.segments()
        starts = [s for s, _ in segs]
        by = {}
        for s, t in self.gaps():
            k = bisect.bisect_right(starts, (s + t) // 2) - 1
            name = segs[k][1] if k >= 0 and segs[k][1] else "outside ranges"
            by[name] = by.get(name, 0) + (t - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], ns / 1e9] for n, ns in rows]
