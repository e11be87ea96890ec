"""A run's plumbing on the CPU: the window loop, the last line's keys,
the checks, and what a run without a card does."""

import json
import os
import subprocess
import sys
import time

import pytest

from msabench import run
from msabench.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_METRICS = {"peak_mem_gb", "device_idle", "gotoh_row_wave_roofline",
                  "gotoh_row_cluster_roofline"}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_on_the_cpu(tiny_root, trace):
    out = run.run_cell(tiny_root, "tiny", 2 ** 31 + 7, 0.01, trace,
                       device="cpu", t_start=time.perf_counter())
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 1
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    assert not names & DEVICE_METRICS
    if trace:
        # the per-layer metrics that list their cells do not list this
        # one; device_idle has no CPU reading
        assert names == {"tiny_aligned"}
        assert out["metrics"]["tiny_aligned"] == {"value": 1.0,
                                                  "unit": "count"}
    else:
        assert names == {"align_s", "setup_s"}
    assert out["checks"]["rows_wrong"] == {"value": 0, "limit": 0}
    assert out["checks"]["sp_miss"]["value"] <= 0.05
    json.dumps(out)


def test_the_window_runs_until_its_seconds_have_passed(tiny_root):
    out = run.run_cell(tiny_root, "tiny", 5, 2.0, 0, device="cpu")
    walls = out["alignments_s"]
    window = out["metrics"]["align_s"]["value"] * out["attempted"]
    assert out["attempted"] == len(walls)
    # every alignment but the last started before 2 s had passed, and
    # the window ends with the last one
    assert sum(walls[:-1]) < 2.0 <= window
    assert window >= sum(walls)


def test_the_window_refuses_to_outrun_its_families(tiny_root):
    with pytest.raises(RuntimeError, match="outran"):
        run.run_cell(tiny_root, "tiny", 5, 3600.0, 0, device="cpu")


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    rc = run.main(["--workload", "plastome_default", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """A directory with BENCHMARK.json and msabench/ alone: no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "msabench"), tmp_path / "msabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "-m", "msabench.run",
                          "--workload", "plastome_default", "--seed", "3",
                          "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_the_program_span_and_counter_readers():
    from msabench import manifest
    r = run.Run({}, {}, {}, 1, 1.0, "cpu")
    r.window_s = 9.0
    r.alignments = [
        {"phase_times": {"distances": 1.0, "tree": 2.0, "progressive": 3.0},
         "fetches": 5},
        {"phase_times": {"distances": 2.0, "tree": 4.0, "progressive": 5.0,
                         "consistency": 1.5}, "fetches": 7}]
    bench = manifest.Manifest(ROOT)
    got = {m: bench.reader(m).read(r) for m in (
        "align_s", "distances_s", "tree_s", "consistency_s",
        "progressive_s", "progressive_fetches", "device_idle",
        "gotoh_row_wave_roofline")}
    assert got == {"align_s": 4.5, "distances_s": 1.5, "tree_s": 3.0,
                   "consistency_s": 1.5, "progressive_s": 4.0,
                   "progressive_fetches": 6.0, "device_idle": None,
                   "gotoh_row_wave_roofline": None}


def test_judge_takes_the_worst_or_the_pooled_share():
    import types
    most = types.SimpleNamespace(value=lambda fam, rows, recs, ctx: fam)
    pool = types.SimpleNamespace(
        counts=lambda fam, rows, recs, ctx: (1 if fam > 0.5 else 0, 4),
        value=None)
    r = run.Run({}, {"limits": {"most": 0.6, "pool": 0.2}}, {}, 1, 1.0,
                "cpu")
    got = run.judge(r, {"most": most, "pool": pool}, [0.1, 0.7, 0.9],
                    [None] * 3)
    # most: 0.9 > 0.6 fails the third; pool: 2 of 12 = 0.17 passes
    assert got["checks"]["most"] == {"value": 0.9, "limit": 0.6}
    assert got["checks"]["pool"]["value"] == 2 / 12
    assert got["failed"] == 2
    r.config["limits"]["pool"] = 0.1
    assert run.judge(r, {"most": most, "pool": pool}, [0.1, 0.7, 0.9],
                     [None] * 3)["failed"] == 3
