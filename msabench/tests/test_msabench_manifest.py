"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

from msabench import manifest, tracing
from msabench.tests.conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    BENCH = json.load(_fh)
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_the_file_has_the_contracts_keys_and_size():
    assert set(BENCH) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for key, allowed in ENTRY_KEYS.items():
        for e in BENCH[key]:
            extra = set(e) - allowed - ({"workloads"} if key in (
                "end_to_end", "per_layer") else set())
            assert not extra and allowed <= set(e), (key, e)


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in cmd:
        assert not w.startswith("/") and ".." not in w


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            assert manifest.NAME.match(e["name"]), e["name"]
            names.append((key in ("end_to_end", "per_layer"), e["name"]))
            for text in ("why", "source", "layer"):
                if text in e:
                    assert TEXT.match(e[text]), (e["name"], text)
            if "unit" in e:
                assert manifest.UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert manifest.NAME.match(w["config"])
        assert manifest.NAME.match(w["traffic"])


def test_configurations_are_found_and_used():
    bench = manifest.Manifest(ROOT)
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = bench.config(c["name"])
        assert len(c["reduced"]) <= 16
        assert set(c["reduced"]) <= set(cfg) and \
            cfg["reduced"] == c["reduced"]
        assert cfg["limits"]["sp_miss"] > 0
        assert cfg["limits"]["rows_wrong"] == 0
        assert cfg["family"]["alphabet"] in ("dna", "protein")
        for check in cfg["limits"]:
            assert manifest.NAME.match(check)
            assert callable(bench.check(check).value)


def test_cells_are_found():
    bench = manifest.Manifest(ROOT)
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert w["chips"] in (1, 4)
        t = bench.traffic(w["traffic"])
        assert {"mode", "engine", "autoroute", "families"} <= set(t)


def test_metrics_are_found_and_every_cell_reports_enough():
    bench = manifest.Manifest(ROOT)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert m["source"] in manifest.END_TO_END_SOURCES
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in manifest.SOURCES
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert callable(bench.reader(m["name"]).read)
    for c in cells:
        reported = {m["name"] for m in bench.metrics(c, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics(c, True)
        for m in bench.metrics(c, True):
            assert m["moves"] in reported


def test_hooks_name_what_the_program_has():
    bench = manifest.Manifest(ROOT)
    for m in BENCH["per_layer"]:
        mod = bench.reader(m["name"])
        for target in filter(None, (getattr(mod, "RANGE", None),
                                    (getattr(mod, "PROBE", None) or
                                     (None,))[0])):
            owner, name = tracing._resolve(target)
            assert callable(getattr(owner, name)), target
    for c in BENCH["configs"]:
        for check in bench.config(c["name"])["limits"]:
            for target, fn in getattr(bench.check(check), "AROUND", ()):
                owner, name = tracing._resolve(target)
                assert callable(getattr(owner, name)), target
                assert callable(fn)


def test_a_cell_config_mix_and_metric_are_added_by_files(tiny_root):
    """The throwaway entries of conftest.tiny_root are found without an
    edit to any file that was there."""
    bench = manifest.Manifest(tiny_root)
    assert bench.workload("tiny")["config"] == "tiny_dna"
    assert bench.config("tiny_dna")["sequences"] == 6
    assert bench.traffic("tiny")["families"] == 6
    assert "tiny_aligned" in [m["name"] for m in bench.metrics("tiny", True)]
    assert "tiny_aligned" not in [m["name"] for m in
                                  bench.metrics(BENCH["workloads"][0]["name"],
                                                True)]
    with pytest.raises(KeyError):
        bench.workload("absent")
