"""The four-card cell's configuration and readers on the CPU: the
control at a test size, and the band kernel's roofline reader on probe
records (also where the program gives it nothing to read)."""

import json
import os
import types

import pytest
import torch

from msabench import counts, manifest
from msabench.tests.conftest import ROOT
from msabench.tests.test_msabench_control import reading


def test_the_khv_control_is_not_correct_at_a_test_size():
    """khv_family's generator at 2,000 nt: the plain reference aligner in
    float32 within sp_miss's limit, in bfloat16 (the precision below the
    configuration's) past it.  At the cell's own size the control does not
    fit a card (a pair's pointers alone are 87 GB)."""
    cfg = manifest.Manifest(ROOT).config("khv_family")
    cfg = dict(cfg, sequences=4,
               family=dict(cfg["family"], root_len=2000, lo=1900, hi=2100))
    limit = cfg["limits"]["sp_miss"]
    assert reading(cfg, 11, 2, torch.float32, "cpu") <= limit
    assert reading(cfg, 11, 2, torch.bfloat16, "cpu") > limit


def _reader(name):
    return manifest.Manifest(ROOT).reader(name)


def _band(route, c0=0, Wd=1024):
    cfg = None if route is None else types.SimpleNamespace(route=route)
    band = {"c0": c0, "dec": torch.zeros((1, Wd), dtype=torch.int8)}
    if cfg is not None:
        band["cfg"] = cfg
    return band


def test_the_band_roofline_counts_the_rows_and_columns_a_launch_needs():
    """Each launch's least time counts the rows below la and the band's
    columns below lb at the row kernels' bytes and operations a cell,
    and its strips; launches of the cluster route, or of a band the
    program gave no plan (the parent's), are not recorded."""
    mod = _reader("gotoh_band_wave_roofline")
    rec = mod.record((_band("wave", c0=1024), None, None, None, 512, 512,
                      900, 1500, False), {})
    assert rec == (512, 512, 900, 1500, 1024, 1024, False)
    rows, cols = 900 - 512, 1500 - 1024
    b, ops = counts.gotoh_launch([rows], [cols])
    b += 2 * (rows + 1) * mod.STRIP * 4
    assert mod.least_s(rec) == pytest.approx(counts.bound_s(b, ops)[0])
    assert mod.least_s((0, 512, 900, 1000, 1024, 1024, True)) == 0.0
    assert mod.record((_band("cluster"), None, None, None, 0, 512, 900,
                       1500, True), {}) is None
    assert mod.record((_band(None), None, None, None, 0, 512, 900, 1500,
                       True), {}) is None


def test_the_band_roofline_reads_the_trace():
    mod = _reader("gotoh_band_wave_roofline")
    recs = [(0, 512, 512, 4096, 0, 1024, True),
            (0, 512, 512, 4096, 1024, 1024, False)]
    least = sum(mod.least_s(r) for r in recs)

    class Trace:
        def kernel_s(self, name):
            assert name == "gotoh_band_wave_kernel"
            return 4 * least
    run = types.SimpleNamespace(probes={"gotoh_band_wave_roofline":
                                        recs + [None]}, trace=Trace())
    assert mod.read(run) == pytest.approx(25.0)
    run.probes = {"gotoh_band_wave_roofline": [None]}
    assert mod.read(run) is None


@pytest.mark.parametrize("name, phase", [("mesh_bands_s", "mesh.bands"),
                                         ("mesh_walk_s", "mesh.walk")])
def test_the_mesh_spans_are_read_per_alignment(name, phase):
    mod = _reader(name)
    run = types.SimpleNamespace(alignments=[
        {"phase_times": {phase: 2.0}}, {"phase_times": {phase: 4.0}}])
    assert mod.read(run) == 3.0
    run.alignments = [{"phase_times": {}}]
    assert mod.read(run) is None


def test_the_card_peak_reads_nothing_off_the_card():
    run = types.SimpleNamespace(device="cpu")
    assert _reader("mesh_card_peak_gb").read(run) is None


def test_the_mesh_cell_is_the_one_four_card_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in four] == ["khv_mesh4"]
    traffic = manifest.Manifest(ROOT).traffic("mesh")
    assert traffic["engine"] == "gpu-mesh" and traffic["mode"] == "default"


# ----------------------------------------------------------------------
# The checks of the column-sharded route against its faults (a small
# KHV family, every merge in 4 bands over 4 CPU shards).

SMALL = dict(sequences=4, root_len=1500, lo=1450, hi=1550)


def _small_family(seed):
    from msabench import families
    cfg = manifest.Manifest(ROOT).config("khv_family")
    cfg = dict(cfg, sequences=SMALL["sequences"],
               family=dict(cfg["family"], root_len=SMALL["root_len"],
                           lo=SMALL["lo"], hi=SMALL["hi"],
                           indels_per_kb=[2.0, 0.5]))
    return cfg, families.of_config(cfg, seed, 0)


def _judged(fam, cfg, fault=None, devices=("cpu",) * 4):
    """The mesh checks' values of one alignment of fam on gpu-mesh over
    the devices (4 CPU shards), with fault planted."""
    import contextlib
    import gc

    import kalign_tpu_torch
    from kalign_tpu_torch.gpu.engine import GpuEngine
    from kalign_tpu_torch.parallel import mesh as TM
    from msabench import tracing
    from msabench.tests import mesh_faults
    bench = manifest.Manifest(ROOT)
    checks = {name: bench.check(name)
              for name in ("score_miss", "edge_shortfall", "sp_miss")}
    into, where = {}, {"k": 0}
    plant = contextlib.nullcontext() if fault is None else \
        mesh_faults.FAULTS[fault]()
    # an earlier call's engine and its queue's buffers freed first
    gc.collect()
    with tracing.captures(checks, into, where), plant:
        engine = GpuEngine(mesh=TM.make_mesh(devices=list(devices)))
        msa = kalign_tpu_torch.align_msa(fam[0], mode="default",
                                         engine=engine, device=devices[0])
        rows = msa.aligned_rows()
    ctx = {"seed": [11, 0, 1], "config": cfg,
           "traffic": manifest.Manifest(ROOT).traffic("mesh")}
    return {name: mod.value(fam, rows, [r for _, r in into.get(name, [])],
                            ctx) for name, mod in checks.items()}


@pytest.fixture(scope="module")
def forced_long():
    from kalign_tpu_torch.gpu.engine import GpuEngine
    mp = pytest.MonkeyPatch()
    mp.setattr(GpuEngine, "row_feasible", staticmethod(lambda B, L2p: False))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def small(forced_long):
    cfg, fam = _small_family(23)
    return cfg, fam, _judged(fam, cfg)


def test_the_mesh_checks_pass_a_sound_alignment(small):
    cfg, fam, got = small
    limits = cfg["limits"]
    print("sound", got)
    assert got["score_miss"] <= limits["score_miss"]
    assert got["edge_shortfall"] <= limits["edge_shortfall"]


@pytest.mark.parametrize("fault, check", [("halo_reset", "score_miss"),
                                          ("halo_reset", "edge_shortfall"),
                                          ("match_bf16", "score_miss")])
def test_a_mesh_fault_fails_its_check(small, fault, check):
    """The halo left out reports scores no path has and leaves detours at
    the band edges; the bfloat16 control's forward adds up other scores
    than the float32 match gives its path."""
    cfg, fam, _ = small
    got = _judged(fam, cfg, fault)
    print(fault, got)
    assert got[check] > cfg["limits"][check]


def test_a_wrong_handoff_leaves_a_detour_at_the_edge(forced_long):
    """A family whose root merge crosses a band edge inside a gap (an
    indel planted across column 1024, an edge of the 4 bands of 512):
    with the state handed left zeroed, the path's part at that edge falls
    short of the best by a gap's cost."""
    cfg, fam = _small_family(23)
    seqs, ids = fam
    # a 12-letter deletion from every second sequence straddling the edge
    seqs = [s if k % 2 else s[:1018] + s[1030:] for k, s in enumerate(seqs)]
    ids = [x if k % 2 else list(x[:1018]) + list(x[1030:])
           for k, x in enumerate(ids)]
    fam = (seqs, ids)
    sound = _judged(fam, cfg)
    got = _judged(fam, cfg, "handoff_zeroed")
    print("sound", sound, "handoff_zeroed", got)
    assert sound["edge_shortfall"] <= cfg["limits"]["edge_shortfall"]
    assert got["edge_shortfall"] > cfg["limits"]["edge_shortfall"]


@pytest.mark.card
def test_mesh_faults_at_the_cells_size(card):
    """khv_mesh4 at its own size on the machine's cards (four): set up as
    a run sets up, then for each seed of MSABENCH_FAULT_SEEDS (one by
    default) the seed's first family aligned as the window aligns it,
    sound and with each fault of mesh_faults.py planted (MSABENCH_FAULTS;
    all by default), every check of the configuration read as a run reads
    it; each reading is printed as a JSON line, with whether the rows are
    the sound ones (a fault whose alignment raises, as a halo left out
    does at 295 kb by widening the profiles past what a route takes, is
    printed as raised: a run that raises is not correct).  A sound reading past a limit, or a
    fault that changed the rows and that no check sees, fails the test."""
    import gc

    import torch
    from msabench import families, run
    from msabench.tests import mesh_faults
    from msabench.tests.test_msabench_faults import one_alignment
    bench = manifest.Manifest(ROOT)
    w = bench.workload("khv_mesh4")
    cfg = bench.config(w["config"])
    limits = cfg["limits"]
    seeds = [int(s) for s in os.environ.get(
        "MSABENCH_FAULT_SEEDS", "4230000001").split(",")]
    names = os.environ.get("MSABENCH_FAULTS",
                           ",".join(mesh_faults.FAULTS)).split(",")
    checks = {name: bench.check(name) for name in limits}
    r = run.Run(w, cfg, bench.traffic(w["traffic"]), seeds[0], 0.0, "cuda")
    run.setup(r)
    bad = []
    for seed in seeds:
        r.seed = seed
        fam = families.of_config(cfg, seed, 0)
        sound, values = one_alignment(r, checks, fam)
        print(json.dumps({"cell": w["name"], "seed": seed, "fault": None,
                          "wall_s": r.alignments[0]["wall_s"],
                          "values": values}), flush=True)
        bad += [(seed, None, n) for n in values if values[n] > limits[n]]
        for fault in names:
            try:
                with mesh_faults.FAULTS[fault]():
                    rows, values = one_alignment(r, checks, fam)
            except Exception as e:      # noqa: BLE001 - any raise fails a run
                print(json.dumps({"cell": w["name"], "seed": seed,
                                  "fault": fault, "raised": repr(e)[:300]}),
                      flush=True)
                gc.collect()
                torch.cuda.empty_cache()
                continue
            same = rows == sound
            print(json.dumps({"cell": w["name"], "seed": seed,
                              "fault": fault,
                              "wall_s": r.alignments[0]["wall_s"],
                              "same_rows": same, "values": values}),
                  flush=True)
            if not same and all(values[n] <= limits[n] for n in values):
                bad.append((seed, fault, "seen by no check"))
    assert not bad
