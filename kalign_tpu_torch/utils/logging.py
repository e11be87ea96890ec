"""Timestamped stderr logging + phase timers.

Equivalent of the reference's LOG_MSG/WARNING_MSG + DECLARE/START/STOP
TIMER macros (tldevel.h:42-140): messages go to stderr with wall-clock
timestamps and are silenced by quiet mode; timers report seconds per
pipeline phase (distance, tree, align, ...).
"""

import sys
import time
from contextlib import contextmanager


def log(msg: str, quiet: bool = False):
    if not quiet:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        print(f"[{ts}] :     LOG : {msg}", file=sys.stderr)


def warn(msg: str, quiet: bool = False):
    if not quiet:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        print(f"[{ts}] : WARNING : {msg}", file=sys.stderr)


@contextmanager
def timer(label: str, quiet: bool = False):
    t0 = time.perf_counter()
    yield
    if not quiet:
        log(f"{label} took {time.perf_counter() - t0:.4f} seconds.", quiet)


class PhaseTimes(dict):
    """Accumulates per-phase wall times; render with .report()."""

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self[name] = self.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self, quiet: bool = False):
        for name, secs in self.items():
            log(f"phase {name}: {secs:.4f} s", quiet)
