"""The port end to end on the CPU (every kernel's plain version) against
kalign_tpu's throughput engine: ``engine="tpu-fast"`` in its
host-assembled form (KALIGN_TPU_NO_RESIDENT=1) without the divergent-
family autoroute (KALIGN_TPU_NO_AUTOROUTE=1), which is what the port's
gpu-fast engine reproduces with autoroute=False, in --fast mode and in
default mode (anchor consistency).
Also the scoring model, the anchors, the distances and the native guide
tree, piece by piece."""

import os

import numpy as np
import pytest

from kalign_tpu import engine as JE
from kalign_tpu.core import alphabet as jalpha
from kalign_tpu.core import io as jio
from kalign_tpu.core import params as JP
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch import native as tnative
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core import params as TP
from kalign_tpu_torch.gpu import distances

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CASES = ["BB11001", "BB12006", "BB30014"]


def _jax_fast(path, monkeypatch, consistency=0):
    monkeypatch.setenv("KALIGN_TPU_NO_RESIDENT", "1")
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    m = jio.read_alignment(path)
    m.quiet = True
    return JE.align_msa(m, consistency_anchors=consistency,
                        engine="tpu-fast")


FILES = [c + ".tfa" for c in CASES] + ["small.fa"]


@pytest.mark.parametrize(
    "case,consistency",
    [(f, 0) for f in FILES] + [(f, 5) for f in FILES],
    ids=FILES + [f + "-default" for f in FILES])
def test_fast_alignment_matches_tpu_fast(case, consistency, monkeypatch):
    """Byte-identical FASTA and bitwise-equal per-merge scores, on the
    protein sets and on a tie-heavy DNA set, in --fast mode
    (consistency 0) and in default mode (consistency 5).  (A case where a
    near-tie resolves differently would instead have to show equal
    per-merge scores and be listed in ROADMAP.md section 3, as
    big_dna.fa is.)"""
    path = os.path.join(DATA, case)
    ref = _jax_fast(path, monkeypatch, consistency)
    m = tio.read_alignment(path)
    m.quiet = True
    out = TE.align_msa(m, consistency_anchors=consistency, device="cpu",
                       autoroute=False)
    assert tio.format_alignment(out, "fasta") == \
        jio.format_alignment(ref, "fasta")
    assert np.array_equal(np.asarray(out.task_confidence),
                          np.asarray(ref.task_confidence))


def test_cli_writes_the_api_alignment(tmp_path):
    import kalign_tpu_torch
    from kalign_tpu_torch import cli
    path = os.path.join(DATA, "BB12006.tfa")
    out = tmp_path / "out.afa"
    assert cli.main(["-i", path, "-o", str(out), "--fast", "--device", "cpu",
                     "-q"]) == 0
    msa = tio.read_alignment(path)
    seqs = [s.seq for s in msa.sequences]
    names = [s.name for s in msa.sequences]
    ref = kalign_tpu_torch.align_msa(seqs, names=names, mode="fast",
                                     device="cpu")
    assert out.read_text() == tio.format_alignment(ref, "fasta")
    # without --fast: the default mode (anchor consistency, K = 5)
    assert cli.main(["-i", path, "-o", str(out), "--device", "cpu",
                     "-q"]) == 0
    ref = kalign_tpu_torch.align_msa(seqs, names=names, device="cpu")
    assert out.read_text() == tio.format_alignment(ref, "fasta")
    fast = kalign_tpu_torch.align_msa(seqs, names=names, mode="fast",
                                      device="cpu")
    assert out.read_text() != tio.format_alignment(fast, "fasta")


def _param_fields(ap):
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in ap.__dict__.items()}


def test_scoring_model_matches_and_round_trips():
    types = [0, JP.KALIGN_TYPE_PROTEIN, JP.KALIGN_TYPE_DNA,
             JP.KALIGN_TYPE_DNA_INTERNAL, JP.KALIGN_TYPE_RNA,
             JP.KALIGN_TYPE_PROTEIN_DIVERGENT,
             JP.KALIGN_TYPE_PROTEIN_PFASUM43, JP.KALIGN_TYPE_PROTEIN_PFASUM60,
             JP.KALIGN_TYPE_PROTEIN_PFASUM_AUTO]
    checked = 0
    for biotype in (JP.BIOTYPE_PROTEIN, JP.BIOTYPE_DNA, JP.BIOTYPE_UNDEF):
        for t in types:
            for lens in ([100, 120], [100, 200]):
                try:
                    jt = JP.resolve_pfasum_auto(t, biotype, lens)
                    ref = JP.aln_param_init(biotype, jt, n_threads=2)
                except ValueError:
                    with pytest.raises(ValueError):
                        TP.aln_param_init(
                            biotype, TP.resolve_pfasum_auto(t, biotype, lens))
                    continue
                tt = TP.resolve_pfasum_auto(t, biotype, lens)
                assert tt == jt
                got = TP.aln_param_init(biotype, tt, n_threads=2)
                assert _param_fields(got) == _param_fields(ref)
                fields = {k: v for k, v in ref.__dict__.items()}
                back = TP.aln_param_from_arrays(**fields)
                assert _param_fields(back) == _param_fields(ref)
                assert back.subm.dtype == np.float32
                checked += 1
    assert checked >= 16


@pytest.mark.parametrize("case", CASES)
def test_anchors_distances_and_tree_match(case):
    path = os.path.join(DATA, case + ".tfa")
    jm = jio.read_alignment(path)
    tm = tio.read_alignment(path)
    for m in (jm, tm):
        m.quiet = True
        m.essential_input_check()
        if m.aligned != 1:
            m.dealign()
        m.sort_len_name()
    jm.encode(jalpha.ALPHA_REDUCED_PROTEIN)
    tm.encode(jalpha.ALPHA_REDUCED_PROTEIN)
    anchors = JE.pick_anchors(jm)
    assert TE.pick_anchors(tm) == anchors
    jcodes = [s.s for s in jm.sequences]
    tcodes = [s.s for s in tm.sequences]
    host = JE.HostEngine()
    dm_j = host.anchor_distances(jcodes, anchors)
    dm_t = distances.anchor_distances(tcodes, anchors, "cpu")
    assert np.array_equal(dm_t.view(np.int32), dm_j.view(np.int32))
    tasks_j, sd_j = host.build_tree(jcodes, dm_j, len(anchors))
    tasks_t, sd_t = tnative.build_tree(tcodes, dm_t, len(anchors))
    assert np.array_equal(tasks_t, tasks_j)
    assert np.array_equal(sd_t.view(np.int32), sd_j.view(np.int32))


def test_non_dyadic_divergence_is_a_near_tie(monkeypatch, tmp_path):
    """DNA under the RNA model (penalties 217 / 39.4 / 292.6, not dyadic):
    the scan transform's prefix sums then depend on their order — the
    port sums left to right in float32, XLA's CPU cumsum associates
    otherwise — so a near-tie may resolve differently (ROADMAP.md §3).
    The first merge whose path or score differs must score equal to rel
    1e-5; later merges see other profiles and may differ more."""
    from kalign_tpu.tpu import engine as JTE
    from kalign_tpu_torch.gpu.engine import GpuEngine
    records = open(os.path.join(DATA, "big_dna.fa")).read().split(">")[1:21]
    path = tmp_path / "dna20.fa"
    path.write_text("".join(">" + r for r in records))
    seen = {"port": [], "jax": []}

    def recorder(orig, key):
        def wrapped(self, handle):
            out = orig(self, handle)
            seen[key].append(out)
            return out
        return wrapped

    monkeypatch.setattr(GpuEngine, "collect_bucket",
                        recorder(GpuEngine.collect_bucket, "port"))
    monkeypatch.setattr(JTE.TpuEngine, "_collect_bucket",
                        recorder(JTE.TpuEngine._collect_bucket, "jax"))
    m = tio.read_alignment(str(path))
    m.quiet = True
    # the host-assembled pass: its buckets come back through
    # collect_bucket, merge by merge in the JAX engine's order
    out = TE.align_msa(m, consistency_anchors=0,
                       engine=GpuEngine("cpu", resident=False),
                       autoroute=False)
    ref = _jax_fast(str(path), monkeypatch)
    assert seen["port"] and len(seen["port"]) == len(seen["jax"])
    first = None
    for (st_p, sc_p), (st_j, sc_j) in zip(seen["port"], seen["jax"]):
        for q in range(len(st_p)):
            same = np.array_equal(np.asarray(st_p[q], np.int8),
                                  np.asarray(st_j[q], np.int8))
            if first is None and (not same or sc_p[q] != sc_j[q]):
                first = (float(sc_p[q]), float(sc_j[q]))
    if first is not None:
        assert abs(first[0] - first[1]) <= 1e-5 * abs(first[1]), first
    raw = {s.name: s.seq for s in tio.read_alignment(str(path)).sequences}
    for msa in (out, ref):
        for s, row in zip(msa.sequences, msa.aligned_rows()):
            assert row.replace("-", "") == raw[s.name]


def test_long_sequence_family_matches_tpu_fast(monkeypatch):
    """Short fragments and one sequence of ~7,300 residues (chip_smoke's
    long family), --fast mode: the merges whose column side is the long
    sequence are wider than 7,168 columns (the cluster row kernel's widths,
    kalign_tpu's XLA scan); FASTA byte-identical to kalign_tpu's, scores
    bitwise."""
    import chip_smoke
    from kalign_tpu.core.msa import Msa as JMsa
    from kalign_tpu_torch.core.msa import Msa as TMsa
    seqs = chip_smoke.long_family(0)
    assert max(map(len, seqs)) > 7168 and min(map(len, seqs)) < 400
    monkeypatch.setenv("KALIGN_TPU_NO_RESIDENT", "1")
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    m = JMsa.from_sequences(seqs)
    m.quiet = True
    ref = JE.align_msa(m, consistency_anchors=0, engine="tpu-fast")
    m = TMsa.from_sequences(seqs)
    m.quiet = True
    out = TE.align_msa(m, consistency_anchors=0, device="cpu",
                       autoroute=False)
    assert any(b["route"] == "row" and b["L2p"] > 7168 and b["L1p"] <= 512
               for b in out.engine_stats["batches"])
    assert tio.format_alignment(out, "fasta") == \
        jio.format_alignment(ref, "fasta")
    assert np.array_equal(np.asarray(out.task_confidence),
                          np.asarray(ref.task_confidence))
