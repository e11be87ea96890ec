"""A run with the timed path broken underneath comes out not correct.

On the CPU, a tiny cell's whole run with each fault of faults.py
planted.  On the card (``-m card``), each genome cell at its own size:
set up once as a run sets up, then for each seed of
MSABENCH_FAULT_SEEDS (comma-separated; three by default) the seed's
first family aligned as the window aligns it, sound and with each fault
of MSABENCH_FAULTS planted, every check of the configuration read as a
run reads it; each reading is printed as a JSON line.
"""

import json
import os
import time

import pytest

from msabench import families, manifest, run, tracing
from msabench.tests import faults
from msabench.tests.conftest import ROOT

CPU_FAULTS = ["token", "half_batch", "consistency_off", "bonus_off",
              "tree_shuffled"]


@pytest.mark.parametrize("fault", CPU_FAULTS)
def test_a_fault_is_not_correct(tiny_root, fault):
    out = run.run_cell(tiny_root, "tiny", 11, 0.01, 0, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"] is True
    with faults.FAULTS[fault]():
        out = run.run_cell(tiny_root, "tiny", 11, 0.01, 0, device="cpu",
                           t_start=time.perf_counter())
    checks = out["checks"]
    print(fault, checks)
    assert out["correct"] is False and out["failed"] == 1
    assert any(c["value"] > c["limit"] for c in checks.values())


def one_alignment(r, checks, fam):
    """Align one family as the window does; (rows, {check: value})."""
    r.alignments, r.captures = [], {}
    with tracing.captures(checks, r.captures, r.k):
        rows = run.window(r, [fam])
    ctx = {"seed": [r.seed, 0, 1], "config": r.config,
           "traffic": r.traffic}
    return rows[0], {name: mod.value(fam, rows[0],
                                     [x for a, x in r.captures.get(name, [])
                                      if a == 0], ctx)
                     for name, mod in checks.items()}


@pytest.mark.card
@pytest.mark.parametrize("cell", ["plastome_default", "sars2_default"])
def test_faults_at_the_cells_size(card, cell):
    bench = manifest.Manifest(ROOT)
    w = bench.workload(cell)
    cfg = bench.config(w["config"])
    seeds = [int(s) for s in os.environ.get(
        "MSABENCH_FAULT_SEEDS",
        "4100000001,4100000002,4100000003").split(",")]
    names = os.environ.get("MSABENCH_FAULTS",
                           "consistency_off,bonus_off,tree_shuffled")
    checks = {name: bench.check(name) for name in cfg["limits"]}
    r = run.Run(w, cfg, bench.traffic(w["traffic"]), seeds[0], 0.0, "cuda")
    run.setup(r)
    bad = []
    for seed in seeds:
        r.seed = seed
        fam = families.of_config(cfg, seed, 0)
        sound, values = one_alignment(r, checks, fam)
        print(json.dumps({"cell": cell, "seed": seed, "fault": None,
                          "wall_s": r.alignments[0]["wall_s"],
                          "values": values}), flush=True)
        bad += [(seed, None, name) for name in values
                if values[name] > cfg["limits"][name]]
        for fault in names.split(","):
            with faults.FAULTS[fault]():
                rows, values = one_alignment(r, checks, fam)
            print(json.dumps({"cell": cell, "seed": seed, "fault": fault,
                              "wall_s": r.alignments[0]["wall_s"],
                              "same_rows": rows == sound,
                              "values": values}), flush=True)
            if all(values[n] <= cfg["limits"][n] for n in values):
                bad.append((seed, fault, "seen by no check"))
    assert not bad
