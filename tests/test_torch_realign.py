"""Realign, post-realign, tree noise and checkpoints of kalign_tpu_torch on
the CPU, against kalign_tpu: the "host" engine against the golden files;
"gpu-fast" (every kernel's plain version) against kalign_tpu's
"tpu-fast" in its host-assembled form without the autoroute
(KALIGN_TPU_NO_RESIDENT=1, KALIGN_TPU_NO_AUTOROUTE=1; the port with
autoroute=False), byte for byte; the random streams and the noisy anchor
distances bitwise; the checkpoint files read across both packages."""

import os

import numpy as np
import pytest

from kalign_tpu import checkpoint as jckpt
from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu.utils.rng import XoshiroRng as JRng
from kalign_tpu_torch import checkpoint as tckpt
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core import params as TP
from kalign_tpu_torch.gpu.consistency import ConsistencyTable
from kalign_tpu_torch.gpu.engine import GpuEngine
from kalign_tpu_torch.utils.rng import XoshiroRng as TRng

from conftest import DATA, GOLDEN


def _read(mod, name, aligned=False):
    if aligned:
        m = mod.read_alignment(os.path.join(GOLDEN, name))
    else:
        m = mod.read_inputs([os.path.join(DATA, name)])
    m.quiet = True
    return m


def _gold(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return fh.read()


@pytest.fixture
def tpu_fast(monkeypatch):
    monkeypatch.setenv("KALIGN_TPU_NO_RESIDENT", "1")
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")


@pytest.mark.parametrize("golden,run", [
    ("big_prot.realign.afa", lambda: TE.align_msa(
        _read(tio, "big_prot.fa"), consistency_anchors=5, realign=1,
        engine="host")),
    ("small.postrealign.afa", lambda: TE.post_realign_msa(
        _read(tio, "small.default.afa", True), engine="host")),
    ("BB11001.postrealign2.afa", lambda: TE.post_realign_msa(
        _read(tio, "BB11001.default.afa", True), engine="host",
        refine=TP.REFINE_CONFIDENT, realign_iterations=2)),
], ids=["big_prot-realign", "small-postrealign", "BB11001-postrealign2"])
def test_host_engine_gives_the_golden_bytes(golden, run):
    assert tio.write_fasta(run()) == _gold(golden)


@pytest.mark.parametrize("case", ["realign", "post_realign"])
def test_gpu_fast_matches_tpu_fast(case, tpu_fast):
    """Byte-identical FASTA and bitwise-equal per-merge scores of the
    last pass: small.fa with one realign pass (default mode), and
    post-realign of small.default.afa."""
    if case == "realign":
        ref = JE.align_msa(_read(jio, "small.fa"), consistency_anchors=5,
                           realign=1, engine="tpu-fast")
        out = TE.align_msa(_read(tio, "small.fa"), consistency_anchors=5,
                           realign=1, device="cpu", autoroute=False)
    else:
        ref = JE.post_realign_msa(_read(jio, "small.default.afa", True),
                                  engine="tpu-fast")
        out = TE.post_realign_msa(_read(tio, "small.default.afa", True),
                                  device="cpu")
    assert tio.write_fasta(out) == jio.write_fasta(ref)
    assert np.array_equal(np.asarray(out.task_confidence),
                          np.asarray(ref.task_confidence))


@pytest.mark.parametrize("engine,refine", [
    ("host", TP.REFINE_ALL), ("host", TP.REFINE_CONFIDENT),
    ("host", TP.REFINE_INLINE), ("gpu-fast", TP.REFINE_CONFIDENT)])
def test_realign_refines_as_the_reference(engine, refine, tpu_fast):
    """Refinement with realign: inline in every pass, ALL / CONFIDENT in
    the last pass only (kalign_tpu/engine.py:386-430); the same bytes as
    kalign_tpu's host engine ("host") or tpu-fast ("gpu-fast")."""
    ref = JE.align_msa(_read(jio, "small.fa"), consistency_anchors=5,
                       realign=1, refine=refine,
                       engine="tpu-fast" if engine == "gpu-fast" else engine)
    out = TE.align_msa(_read(tio, "small.fa"), consistency_anchors=5,
                       realign=1, refine=refine, engine=engine, device="cpu",
                       autoroute=False)
    assert tio.write_fasta(out) == jio.write_fasta(ref)


def test_realign_pass_reuses_the_first_pass_table(monkeypatch):
    """The port builds the consistency table once: a table rebuilt from a
    realign pass's codes and the BPM distances (the first pass's
    seq_distances) is bitwise the one that pass aligned with
    (kalign_tpu's TpuEngine.align rebuilds it in every pass,
    tpu/engine.py:650-656)."""
    seen = []
    orig = GpuEngine.align

    def record(self, codes, tasks, ap, sd, ct=None, refine_mode=0):
        seen.append(([c.copy() for c in codes], ap, np.copy(sd), ct))
        return orig(self, codes, tasks, ap, sd, ct, refine_mode=refine_mode)

    monkeypatch.setattr(GpuEngine, "align", record)
    TE.align_msa(_read(tio, "small.fa"), consistency_anchors=5, realign=2,
                 device="cpu", autoroute=False)
    assert len(seen) == 3
    bpm_sd = seen[0][2]
    for codes, ap, sd, ct in seen[1:]:
        assert not np.array_equal(sd, bpm_sd)  # the realign tree's
        eng = GpuEngine("cpu")
        eng.set_alphabet(codes, ap.subm)
        fresh = ConsistencyTable.build(eng, codes, ap, bpm_sd, 5, 2.0)
        assert ct is seen[0][3]
        assert fresh.anchor_ids == ct.anchor_ids
        assert len(fresh.pos_maps) == len(ct.pos_maps)
        for a, b in zip(fresh.pos_maps, ct.pos_maps):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [1, 7, 42, 2 ** 40 + 3])
def test_rng_streams_equal(seed):
    a, b = JRng(seed), TRng(seed)
    for _ in range(50):
        assert a.next_u64() == b.next_u64()
        assert a.random_double() == b.random_double()
        assert a.random_int(1000) == b.random_int(1000)
        assert a.gaussian(1.0, 0.25) == b.gaussian(1.0, 0.25)


@pytest.mark.parametrize("seed,sigma", [(43, 0.2), (44, 0.2), (3, 2.5)])
def test_noisy_anchor_matrix_is_the_reference_one(seed, sigma):
    """kalign_tpu/engine.py::_build_guide_tree's perturbation (a float32
    multiply per (sequence, anchor), the clamp at 0.1, row-major draws)
    and the port's perturb_distances give the same bits; sigma 2.5 makes
    the clamp bite."""
    rng = np.random.default_rng(seed)
    n, K, stride = 37, 13, 16
    dm = np.zeros((n, stride), np.float32)
    dm[:, :K] = rng.uniform(0.0, 1.0, size=(n, K)).astype(np.float32)

    class Capture:
        def anchor_distances(self, codes, anchors):
            return dm.copy()

        def build_tree(self, codes, d, n_anchors):
            self.dm = d
            return None, None

    msa = _read(jio, "small.fa")
    msa.sequences = (msa.sequences * 4)[:n]
    msa.sequences = [sq.copy() for sq in msa.sequences]
    for sq in msa.sequences:
        sq.len = len(sq.seq)
    monkey_anchors = list(range(K))
    orig = JE.pick_anchors
    JE.pick_anchors = lambda m: monkey_anchors
    try:
        cap = Capture()
        JE._build_guide_tree(msa, cap, JRng(seed), sigma)
    finally:
        JE.pick_anchors = orig
    mine = dm.copy()
    TE.perturb_distances(mine, K, TRng(seed), sigma)
    assert mine.dtype == np.float32
    assert np.array_equal(mine.view(np.uint32), cap.dm.view(np.uint32))
    assert np.array_equal(mine[:, K:], dm[:, K:])
    if sigma > 1:
        assert np.any(mine[:, :K] == np.float32(dm[:, :K] * np.float32(0.1)))


@pytest.mark.parametrize("engine", ["host", "gpu-fast"])
def test_tree_noise_without_a_seed_aligns_as_usual(engine):
    """F4: kalign_tpu applies tree noise only with tree_seed != 0
    (engine.py:321-324); with tree_seed 0 the alignment is the one
    without noise."""
    kw = dict(consistency_anchors=5, engine=engine, device="cpu",
              autoroute=False)
    plain = TE.align_msa(_read(tio, "BB11001.tfa"), **kw)
    noisy = TE.align_msa(_read(tio, "BB11001.tfa"), tree_noise=0.1, **kw)
    assert tio.write_fasta(noisy) == tio.write_fasta(plain)
    if engine == "host":
        # with a seed, the reference's noisy tree
        seeded = TE.align_msa(_read(tio, "BB11001.tfa"), tree_seed=5,
                              tree_noise=0.3, **kw)
        ref = JE.align_msa(_read(jio, "BB11001.tfa"), consistency_anchors=5,
                           tree_seed=5, tree_noise=0.3, engine="host")
        assert tio.write_fasta(seeded) == jio.write_fasta(ref)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoints_read_across(direction, tmp_path):
    """A checkpoint written by either package resumes in the other: the
    same files (tasks.txt byte for byte, distances.npz's arrays and
    fingerprint), and the resumed run skips distances and tree and gives
    the uncheckpointed run's bytes."""
    a, b = tmp_path / "a", tmp_path / "b"
    full = TE.align_msa(_read(tio, "BB11001.tfa"), consistency_anchors=5,
                        engine="host", save_checkpoint=str(a))
    JE.align_msa(_read(jio, "BB11001.tfa"), consistency_anchors=5,
                 engine="host", save_checkpoint=str(b))
    assert (a / "tasks.txt").read_bytes() == (b / "tasks.txt").read_bytes()
    za, zb = np.load(a / "distances.npz"), np.load(b / "distances.npz")
    for key in ("dm", "seq_distances", "anchors", "fingerprint"):
        assert np.array_equal(za[key], zb[key])
    src = a if direction == "port_to_reference" else b
    if direction == "port_to_reference":
        out = JE.align_msa(_read(jio, "BB11001.tfa"), consistency_anchors=5,
                           engine="host", resume_checkpoint=str(src))
        assert jio.write_fasta(out) == tio.write_fasta(full)
    else:
        out = TE.align_msa(_read(tio, "BB11001.tfa"), consistency_anchors=5,
                           engine="host", resume_checkpoint=str(src))
        assert tio.write_fasta(out) == tio.write_fasta(full)
        assert "distances" not in out.phase_times
        assert "tree" not in out.phase_times
    tasks = tckpt.read_tasks(str(src / "tasks.txt"))
    assert np.array_equal(tasks, jckpt.read_tasks(str(src / "tasks.txt")))


def test_resume_rejects_other_input(tmp_path):
    TE.align_msa(_read(tio, "BB11001.tfa"), engine="host",
                 save_checkpoint=str(tmp_path))
    with pytest.raises(ValueError):
        TE.align_msa(_read(tio, "BB12006.tfa"), engine="host",
                     resume_checkpoint=str(tmp_path))


def test_post_realign_input_checks():
    from kalign_tpu_torch.core.msa import Msa
    with pytest.raises(ValueError):
        TE.post_realign_msa(Msa.from_sequences(["ACDEF", "ACDE", "ACDF"]),
                            engine="host")
    with pytest.raises(ValueError):
        TE.post_realign_msa(_read(tio, "small.default.afa", True),
                            engine="host", realign_iterations=0)


def test_post_realign_api_and_cli_write_the_golden(tmp_path):
    import kalign_tpu_torch
    from kalign_tpu_torch import cli
    out = tmp_path / "out.afa"
    msa = kalign_tpu_torch.post_realign(
        os.path.join(GOLDEN, "small.default.afa"), str(out), engine="host")
    assert msa.aligned == 3
    assert out.read_text() == _gold("small.postrealign.afa")
    # the CLI's --realign on big_prot.fa, through --save-checkpoint
    out = tmp_path / "r.afa"
    assert cli.main(["-i", os.path.join(DATA, "big_prot.fa"), "-o",
                     str(out), "--realign", "1", "--engine", "host",
                     "--save-checkpoint", str(tmp_path / "ck"), "-q"]) == 0
    assert out.read_text() == _gold("big_prot.realign.afa")
    assert cli.main(["-i", os.path.join(DATA, "big_prot.fa"), "-o",
                     str(out), "--realign", "1", "--engine", "host",
                     "--resume-checkpoint", str(tmp_path / "ck"),
                     "-q"]) == 0
    assert out.read_text() == _gold("big_prot.realign.afa")
