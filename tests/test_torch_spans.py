"""The spans of an alignment (kalign_tpu_torch/utils/logging.py): the
recorder's nesting, ids, parents and self time; msa.phase_times as the
sums of msa.spans; no profiler range while the profiler is off, and each
span a range of the trace while it is on; the native guide tree's parts
and pair counts (kalign_tpu's tasks unchanged); the benchmark's readers
of the new spans and counts."""

import collections
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kalign_tpu import engine as JE
from kalign_tpu_torch import api, native
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.gpu.engine import GpuEngine
from kalign_tpu_torch.utils import logging as L

from conftest import DATA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the stages of a default-mode alignment through the entry point: the
# arguments and the Msa (api.py), then the engine's input, the layers,
# the input's second part between the tree and the maps, the output
STAGES = ["input", "input", "distances", "tree", "input", "consistency",
          "progressive", "output"]


def _seqs(name="BB11001.tfa"):
    return [sq.seq for sq in tio.read_inputs([os.path.join(DATA, name)])
            .sequences]


def test_recorder_nesting_ids_parents_and_self_time():
    with L.recording() as rec:
        assert L.current() is rec
        with rec.span("a") as a:
            with L.span("a.b"):
                time.sleep(0.002)
            L.add("a.c", a.start, 0.5)
        with L.recording() as same:
            assert same is rec
            with L.recording(fresh=True) as other:
                assert L.current() is other and other.id != rec.id
                with L.span("x"):
                    pass
            assert L.current() is rec
        time.sleep(0.002)
    assert L.current() is None
    with L.span("nowhere"):
        pass
    L.add("nowhere", 0.0, 1.0)
    root, a, b, c = rec.spans
    assert [s.name for s in rec.spans] == [L.ROOT, "a", "a.b", "a.c"]
    assert {s.id for s in rec.spans} == {rec.id}
    assert [s.parent for s in rec.spans] == [None, 0, 1, 1]
    assert c.summed and not any(s.summed for s in (root, a, b))
    assert root.start <= a.start <= b.start <= b.end <= a.end <= root.end
    assert [s.name for s in other.spans] == [L.ROOT, "x"]
    times = rec.times()
    assert list(times) == ["a", "a.b", "a.c", L.UNSPANNED]
    assert times["a"] == a.end - a.start
    assert times["a.c"] == 0.5
    assert times[L.UNSPANNED] == pytest.approx(
        (root.end - root.start) - (a.end - a.start), abs=1e-12)
    assert times[L.UNSPANNED] >= 0.002
    assert rec.sums("a.") == {"b": b.end - b.start, "c": 0.5}
    assert rec.sums("a.", first=3) == {"c": 0.5}


def test_a_record_survives_a_raise():
    with pytest.raises(ValueError):
        with L.recording() as rec:
            with rec.span("input"):
                raise ValueError("bad input")
    assert L.current() is None
    assert all(s.end is not None for s in rec.spans)


def test_phase_times_are_the_sums_of_the_spans():
    """One record an alignment, its own id; the stages in order, not
    overlapping; each phase_times key its spans' seconds; the root's
    children and its self time add up to its wall."""
    outs = [api.align_msa(_seqs(), device="cpu") for _ in range(2)]
    assert outs[0].spans[0].id != outs[1].spans[0].id
    for out in outs:
        spans, times = out.spans, out.phase_times
        root = spans[0]
        assert root.name == L.ROOT and root.parent is None
        assert {s.id for s in spans} == {root.id}
        assert all(s.end is not None for s in spans)
        by_name = collections.defaultdict(float)
        for s in spans[1:]:
            by_name[s.name] += s.end - s.start
        assert {k: v for k, v in times.items() if k != L.UNSPANNED} == \
            pytest.approx(dict(by_name), rel=0, abs=1e-12)
        top = [s for s in spans if s.parent == 0]
        assert [s.name for s in top] == STAGES
        for x, y in zip(top, top[1:]):
            assert x.end <= y.start
        assert sum(s.end - s.start for s in top) + times[L.UNSPANNED] == \
            pytest.approx(root.end - root.start, rel=1e-9)
        for s in spans[1:]:
            parent = spans[s.parent]
            assert s.name.startswith(parent.name + ".") or \
                s.name.startswith("progressive.") or parent.parent is None
        assert set(out.engine_stats["progressive_split_s"]) == {
            k.split(".", 1)[1] for k in times
            if k.startswith("progressive.")}
        for part, secs in out.engine_stats["progressive_split_s"].items():
            assert secs == times["progressive." + part]


def test_no_range_while_the_profiler_is_off(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    out = api.align_msa(_seqs(), device="cpu")
    assert len(out.spans) > 10
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        out = api.align_msa(_seqs(), device="cpu")
    assert sorted(entered) == sorted(L.range_name(s.name)
                                     for s in out.spans if not s.summed)


def test_the_recorder_and_the_native_binding_do_not_import_torch():
    """utils/logging.py looks torch up only where it was imported: the
    logger and the ctypes binding load, and a span opens and closes,
    without it."""
    code = ("import sys\n"
            "from kalign_tpu_torch import native\n"
            "from kalign_tpu_torch.utils import logging as L\n"
            "with L.recording() as rec:\n"
            "    with rec.span('tree'):\n"
            "        pass\n"
            "assert [s.name for s in rec.spans] == ['align', 'tree']\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _innermost(ivals, k):
    """The index of the innermost interval holding interval k."""
    s, t = ivals[k][:2]
    best = None
    for j, (a, b, _) in enumerate(ivals):
        if j != k and a <= s and t <= b and (
                best is None or a >= ivals[best][0]):
            best = j
    return best


def test_every_span_is_a_range_under_the_profiler():
    """On the profiler's clock: one range per span (the native tree's
    summed parts aside), named layer.<span> or progressive.<part>, nested
    as the spans are."""
    seqs = _seqs("BB12006.tfa")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = api.align_msa(seqs, device="cpu")
    events = prof.profiler.kineto_results.events()
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.name()) for e in events
                     if e.name().startswith(("layer.", "progressive."))),
                    key=lambda r: (r[0], -r[1]))
    spans = [s for s in out.spans if not s.summed]
    assert all(L.range_name(s.name).startswith(("layer.", "progressive."))
               for s in out.spans)
    assert [r[2] for r in ranges] == [L.range_name(s.name) for s in spans]
    index = {id(s): k for k, s in enumerate(spans)}
    for k, s in enumerate(spans):
        want = None if s.parent is None else index[id(out.spans[s.parent])]
        assert _innermost(ranges, k) == want, (k, s)
    # the native tree's k-means rounds and joins are summed spans; its leaf
    # sets' pair distances, one batch on the engine's device, a range
    assert {s.name for s in out.spans if s.summed} == {"tree.splits",
                                                       "tree.upgma"}
    assert [s.name for s in spans].count("tree.pairs") == 1


def _codes(rng, n, lo=60, hi=120):
    return [rng.integers(0, 4, size=int(rng.integers(lo, hi)),
                         dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("groups", [(10,), (25, 35)],
                         ids=["one-upgma", "two-leaf-sets"])
def test_native_tree_parts_and_pair_counts(groups):
    """10 sequences: one UPGMA, 45 pair distances computed and needed.
    60 sequences in two clusters of the anchor embedding, 25 and 35: one
    k-means split, then a UPGMA each: sum n_i (n_i - 1) / 2 computed
    (each distinct pair once) and needed.  The tasks and distances are
    kalign_tpu's, bit for bit."""
    rng = np.random.default_rng(len(groups))
    n, na = sum(groups), 5
    codes = _codes(rng, n)
    dm = np.zeros((n, 8), np.float32)
    first = 0
    for g, size in enumerate(groups):
        dm[first:first + size, :na] = 10.0 * g + rng.random(
            (size, na), dtype=np.float32)
        first += size
    counts = {}
    with L.recording() as rec:
        with rec.span("tree"):
            tasks, sd = native.build_tree(codes, dm, na, counts=counts)
    assert counts == {
        "tree_pairs_computed": sum(g * (g - 1) // 2 for g in groups),
        "tree_pairs_needed": sum(g * (g - 1) // 2 for g in groups)}
    parts = [s for s in rec.spans if s.summed]
    assert [s.name for s in parts] == list(native.TREE_PARTS)
    assert all(s.parent == 1 for s in parts)
    assert (parts[0].end - parts[0].start > 0) == (len(groups) > 1)
    assert parts[1].end - parts[1].start > 0
    for x, y in zip(parts, parts[1:]):
        assert x.end == y.start
    assert parts[-1].end <= rec.spans[1].end
    want_tasks, want_sd = JE.HostEngine().build_tree(codes, dm, na)
    assert tasks.tobytes() == want_tasks.tobytes()
    assert sd.tobytes() == want_sd.tobytes()


def test_device_tree_spans_and_counts():
    """The device k-means tree (its plain version on the CPU): tree_s
    from the spans tree.splits and tree.upgma, the leaf sets' pair counts
    summed over the native UPGMAs."""
    rng = np.random.default_rng(7)
    codes = _codes(rng, 120)
    dm = np.zeros((120, 8), np.float32)
    dm[:, :6] = rng.random((120, 6), dtype=np.float32)
    eng = GpuEngine("cpu", device_tree=True)
    with L.recording() as rec:
        with rec.span("tree"):
            eng.build_tree(codes, dm, 6)
    st = eng.stats
    assert st["tree"] == "device_fused"
    names = [s.name for s in rec.spans[2:]]
    assert names == ["tree.splits", "tree.upgma"]
    assert st["tree_s"] == {
        "splits_s": rec.spans[2].end - rec.spans[2].start,
        "upgma_s": rec.spans[3].end - rec.spans[3].start}
    assert 0 < st["tree_pairs_needed"] == st["tree_pairs_computed"] \
        <= 49 * 120 // 2
    # outside any alignment the engine records the same keys
    eng = GpuEngine("cpu", device_tree=True)
    eng.build_tree(codes, dm, 6)
    assert set(eng.stats["tree_s"]) == {"splits_s", "upgma_s"}


def _run_with(alignments, probes=None):
    from msabench import run
    r = run.Run({}, {}, {}, 1, 1.0, "cpu")
    r.window_s = 10.0
    r.alignments = alignments
    r.probes = probes or {}
    return r


def test_the_span_and_pair_count_readers():
    from msabench import manifest
    bench = manifest.Manifest(ROOT)
    r = _run_with(
        [{"phase_times": {"input": 0.5, "tree": 4.0, "tree.pairs": 3.0,
                          "output": 0.25, "unspanned": 0.01}},
         {"phase_times": {"input": 0.7, "tree": 6.0, "tree.pairs": 5.0,
                          "output": 0.35, "unspanned": 0.03}}],
        {"tree_pair_yield": [(28, 64), None, (2016, 4096)]})
    got = {m: bench.reader(m).read(r) for m in (
        "input_s", "output_s", "unspanned_s", "tree_pairs_s",
        "tree_pair_yield")}
    assert got == {"input_s": pytest.approx(0.6),
                   "output_s": pytest.approx(0.3),
                   "unspanned_s": pytest.approx(0.02),
                   "tree_pairs_s": 4.0,
                   "tree_pair_yield": 100.0 * 2044 / 4160}
    assert bench.reader("tree_pair_yield").read(_run_with(
        [], {"tree_pair_yield": [(28, 64)] * 3})) == 43.75
    # a program without the spans or the counts: nothing to report
    old = _run_with([{"phase_times": {"distances": 1.0, "tree": 2.0}}],
                    {"tree_pair_yield": [None, None]})
    assert [bench.reader(m).read(old) for m in (
        "input_s", "output_s", "unspanned_s", "tree_pairs_s",
        "tree_pair_yield")] == [None] * 5
    # the probe's record of a finished Msa
    record = bench.reader("tree_pair_yield").record
    out = api.align_msa(_seqs(), device="cpu")
    st = out.engine_stats
    assert record((out,), {}) == (st["tree_pairs_needed"],
                                  st["tree_pairs_computed"])
    out.engine_stats = {"engine": "gpu-fast"}
    assert record((out,), {}) is None
