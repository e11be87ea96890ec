"""Timestamped stderr logging, and the spans of an alignment.

``log`` / ``warn`` are the reference's LOG_MSG / WARNING_MSG (tldevel.h:
42-140): messages go to stderr with wall-clock timestamps and are
silenced by quiet mode.  ``took`` gives the reference's timer lines
("Alignment took ... seconds.") from the spans below.

Spans.  One record (``PhaseTimes``) holds the spans of one alignment
under one id: each span its name (a dotted path: "tree", "tree.pairs",
"progressive.merge"), start and end (``time.perf_counter`` seconds),
the span that encloses it and the record's id.  ``recording`` opens a
record for a call of the entry point, whose root span ("align") the
call is, or joins the one the thread has open; the code below opens its
spans through the module's ``span`` and ``add``, which find the record
the thread has open and do nothing where there is none.  The record
stays in memory: ``attach`` hands its spans to the finished Msa
(``msa.spans``) and their seconds by name (``msa.phase_times``, with the
root's self time, its wall less its children's, under "unspanned").

While a torch.profiler session is on, each span is also a
``record_function`` range, so a trace holds the spans, nested as they
are, on the clock of the kernels they launched.  A range's name is the
span's prefixed by "layer.", or the span's own where it begins with
"progressive.": trace readers tell the program's ranges from device
work by these two prefixes (a range drawn over its kernels is a device
event of the range's name).  With the profiler off no range is entered:
a span costs two clock reads and an append.
"""

import itertools
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

ROOT = "align"
UNSPANNED = "unspanned"

_ids = itertools.count(1)
_local = threading.local()
_NOTHING = nullcontext()
_clock = time.perf_counter


def _profiler():
    """torch where a torch.profiler session is on, else None (none can
    be where torch was never imported; this module does not import it)."""
    t = sys.modules.get("torch")
    return t if t is not None and t._C._autograd._profiler_enabled() \
        else None


def log(msg: str, quiet: bool = False):
    if not quiet:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        print(f"[{ts}] :     LOG : {msg}", file=sys.stderr)


def warn(msg: str, quiet: bool = False):
    if not quiet:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        print(f"[{ts}] : WARNING : {msg}", file=sys.stderr)


def took(label: str, seconds: float, quiet: bool = False):
    log(f"{label} took {seconds:.4f} seconds.", quiet)


def range_name(name: str) -> str:
    """The torch.profiler range of the span ``name``."""
    return name if name.startswith("progressive.") else "layer." + name


class Span:
    """A timed block of one record, and its context: ``with rec.span(name)
    as s`` opens it (and its range while the profiler is on) and closes
    it.  ``parent`` is the index of the enclosing span in the record's
    list (None for the root); ``end`` is None while the block is open.
    A ``summed`` span is the sum of many intervals inside one native
    call, laid end to end from the call's start: its seconds are
    measured, its place is not, and it has no profiler range."""

    __slots__ = ("name", "start", "end", "parent", "id", "summed", "_rec",
                 "_rf")

    def __init__(self, rec, name, start=None, end=None, summed=False):
        self.name, self.start, self.end = name, start, end
        self.id, self.summed, self._rec, self._rf = rec.id, summed, rec, None
        stack = rec._stack
        self.parent = stack[-1] if stack else None

    @property
    def seconds(self) -> float:
        end = _clock() if self.end is None else self.end
        return end - self.start

    def __enter__(self) -> "Span":
        t = _profiler()
        if t is not None:
            self._rf = t.profiler.record_function(range_name(self.name))
            self._rf.__enter__()
        rec = self._rec
        rec._stack.append(len(rec.spans))
        rec.spans.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        self._rec._stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start!r}, {self.end!r}, "
                f"parent={self.parent}, id={self.id}"
                f"{', summed' if self.summed else ''})")


class PhaseTimes:
    """The spans of one alignment under one id (``spans``: in the order
    they opened; the first is the root)."""

    def __init__(self):
        self.id = next(_ids)
        self.spans = []
        self._stack = []

    def span(self, name: str) -> Span:
        """The span ``name`` of a block (``with rec.span(name) as s``), a
        child of the innermost span open."""
        return Span(self, name)

    def add(self, name: str, start: float, seconds: float):
        """A summed span of ``seconds`` from ``start``, a child of the
        innermost span open."""
        self.spans.append(Span(self, name, start, start + seconds,
                               summed=True))

    def sums(self, prefix: str, first: int = 0) -> dict:
        """{rest of the name: seconds} of the spans from index ``first``
        whose names begin with ``prefix``."""
        out = {}
        for sp in self.spans[first:]:
            if sp.name.startswith(prefix):
                key = sp.name[len(prefix):]
                out[key] = out.get(key, 0.0) + sp.seconds
        return out

    def times(self) -> dict:
        """Seconds by span name, summed over the spans of a name (the
        root's children sum to its wall less UNSPANNED, their children
        to theirs less their own self time), and the root's self time
        under UNSPANNED.  An open span counts up to now."""
        out, root, covered = {}, 0.0, 0.0
        for sp in self.spans:
            secs = sp.seconds
            if sp.parent is None:
                root += secs
                continue
            out[sp.name] = out.get(sp.name, 0.0) + secs
            if self.spans[sp.parent].parent is None:
                covered += secs
        if self.spans:
            out[UNSPANNED] = root - covered
        return out

    def attach(self, msa):
        """Hand the record to a finished Msa: ``msa.spans`` and
        ``msa.phase_times``."""
        msa.spans = self.spans
        msa.phase_times = self.times()


def current() -> Optional[PhaseTimes]:
    """The record this thread has open, if any."""
    records = getattr(_local, "records", None)
    return records[-1] if records else None


@contextmanager
def recording(fresh: bool = False):
    """The record of the alignment under way on this thread; where none
    is open, or with ``fresh``, a new one for the block, which is its
    root span.  A fresh record's block leaves the thread's open record
    aside until it ends."""
    rec = None if fresh else current()
    if rec is not None:
        yield rec
        return
    rec = PhaseTimes()
    records = _local.__dict__.setdefault("records", [])
    records.append(rec)
    try:
        with rec.span(ROOT):
            yield rec
    finally:
        records.pop()


def span(name: str):
    """A block timed as the span ``name`` of the record this thread has
    open (nothing where none is)."""
    rec = current()
    return _NOTHING if rec is None else rec.span(name)


def add(name: str, start: float, seconds: float):
    """A summed span of the record this thread has open, if any."""
    rec = current()
    if rec is not None:
        rec.add(name, start, seconds)
