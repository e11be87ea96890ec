"""The ensemble (--precise) of kalign_tpu_torch on the CPU, against
kalign_tpu: the "host" engine against small.precise.afa; "gpu-fast"
(every kernel's plain version) against kalign_tpu's "tpu-fast" in its
host-assembled form without the autoroute (KALIGN_TPU_NO_RESIDENT=1,
KALIGN_TPU_NO_AUTOROUTE=1; the port with autoroute=False), byte for byte;
the POAR tables, the consensus and the confidences piece by piece; the
POAR files read across both packages; the CLI's flags parsed alike."""

import os

import numpy as np
import pytest

from kalign_tpu import cli as jcli
from kalign_tpu import consensus as jcons
from kalign_tpu import ensemble as jens
from kalign_tpu import poar as jpoar
from kalign_tpu.core import io as jio
from kalign_tpu_torch import cli as tcli
from kalign_tpu_torch import consensus as tcons
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch import ensemble as tens
from kalign_tpu_torch import poar as tpoar
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core.msa import Msa

from conftest import DATA, GOLDEN


def _read(mod, name):
    m = mod.read_inputs([os.path.join(DATA, name)])
    m.quiet = True
    return m


def _seqs(name="small.fa"):
    m = _read(tio, name)
    return [s.seq for s in m.sequences], [s.name for s in m.sequences]


@pytest.fixture
def tpu_fast(monkeypatch):
    monkeypatch.setenv("KALIGN_TPU_NO_RESIDENT", "1")
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")


def test_host_engine_gives_the_precise_golden():
    out = tens.ensemble_align(_read(tio, "small.fa"), n_runs=3, realign=1,
                              consistency_anchors=5, engine="host")
    with open(os.path.join(GOLDEN, "small.precise.afa")) as fh:
        assert tio.write_fasta(out) == fh.read()
    st = out.engine_stats["ensemble"]
    assert st["run_engines"] == ["host"] * 3
    assert st["winner"] in ("selection", "consensus")


@pytest.mark.parametrize("name,realign", [("tiny.fa", 0), ("small.fa", 0),
                                          ("small.fa", 1)],
                         ids=["tiny-ensemble3", "small-ensemble3",
                              "small-precise"])
def test_gpu_fast_matches_tpu_fast(name, realign, tpu_fast):
    """Three runs in default mode: without realign runs 1 and 2 take
    tree noise; with realign 1 (mode "precise", through the API) none
    does.  Same FASTA, the same confidences."""
    ref = jens.ensemble_align(_read(jio, name), n_runs=3, realign=realign,
                              consistency_anchors=5, engine="tpu-fast")
    if realign:
        import kalign_tpu_torch
        seqs, names = _seqs(name)
        out = kalign_tpu_torch.align_msa(seqs, names=names, mode="precise",
                                         device="cpu", autoroute=False)
    else:
        out = tens.ensemble_align(_read(tio, name), n_runs=3,
                                  consistency_anchors=5, device="cpu",
                                  autoroute=False)
    assert tio.write_fasta(out) == jio.write_fasta(ref)
    assert out.engine_stats["ensemble"]["run_engines"] == ["gpu-fast"] * 3
    assert np.array_equal(out.col_confidence, ref.col_confidence)
    for a, b in zip(out.sequences, ref.sequences):
        assert a.confidence == b.confidence


def _runs(n=3):
    """Three alignments of small.fa under the ensemble's run presets."""
    m = _read(tio, "small.fa")
    base = tens._base_penalties(m, 0, -1.0, -1.0, -1.0, 1)
    return [tens._align_one_run(m, k, base, 42, 1, 0, 0, 0.0, -1.0, 0, 0.0,
                                5, 2.0, "host").aligned_rows()
            for k in range(n)]


@pytest.fixture(scope="module")
def tables():
    rows = _runs()
    t, j = tpoar.PoarTable(len(rows[0])), jpoar.PoarTable(len(rows[0]))
    for k, r in enumerate(rows):
        assert np.array_equal(tpoar.pos_matrix(r), jpoar.pos_matrix(r))
        t.extract(tpoar.pos_matrix(r), k)
        j.extract(jpoar.pos_matrix(r), k)
    return rows, t, j


def test_poar_tables_equal(tables):
    rows, t, j = tables
    assert (t.numseq, t.n_alignments, t.n_pairs) == \
        (j.numseq, j.n_alignments, j.n_pairs)
    for p in range(t.n_pairs):
        assert np.array_equal(t.keys[p], j.keys[p])
        assert t.masks[p].dtype == j.masks[p].dtype
        assert np.array_equal(t.masks[p], j.masks[p])
    for r in rows:
        assert t.score_alignment(tpoar.pos_matrix(r)) == \
            j.score_alignment(jpoar.pos_matrix(r))
    keys = t.keys[tpoar.pair_index(0, 3, t.numseq)]
    assert np.array_equal(t.lookup_support(0, 3, keys),
                          j.lookup_support(0, 3, keys))


@pytest.mark.parametrize("min_support", [1, 2, 3])
def test_consensus_and_confidence_equal(tables, min_support):
    """build_consensus through the native binding = build_consensus_py =
    kalign_tpu's; residue_confidence equal."""
    rows, t, j = tables
    ungapped = [r.replace("-", "") for r in rows[0]]
    native = tcons.build_consensus(t, ungapped, min_support)
    assert native == tcons.build_consensus_py(t, ungapped, min_support)
    assert native == jcons.build_consensus(j, ungapped, min_support)
    conf, col = tcons.residue_confidence(t, native)
    jconf, jcol = jcons.residue_confidence(j, native)
    assert np.array_equal(conf, jconf) and np.array_equal(col, jcol)


def test_merged_partial_tables_equal_the_whole(tables):
    rows, t, _ = tables
    parts = []
    for ids in ([0, 2], [1]):
        part = tpoar.PoarTable(t.numseq)
        for k in ids:
            part.extract(tpoar.pos_matrix(rows[k]), k)
        parts.append(part)
    merged = tpoar.merge_poar_tables(parts)
    assert merged.n_alignments == t.n_alignments
    for p in range(t.n_pairs):
        assert np.array_equal(merged.keys[p], t.keys[p])
        assert np.array_equal(merged.masks[p], t.masks[p])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_poar_files_read_across(writer, tables, tmp_path):
    """Either package's POAR file reads in the other and writes back the
    same bytes; --load-poar's consensus is the same from both."""
    rows, t, j = tables
    a, b = tmp_path / "a.poar", tmp_path / "b.poar"
    (t if writer == "port" else j).write(str(a))
    if writer == "port":
        back = jpoar.PoarTable.read(str(a))
    else:
        back = tpoar.PoarTable.read(str(a))
    back.write(str(b))
    assert a.read_bytes() == b.read_bytes()
    m = Msa.from_sequences([r.replace("-", "") for r in rows[0]])
    jm = jio.read_alignment(os.path.join(DATA, "small.fa"))
    out = tens.consensus_from_poar(m, str(a), 2)
    ref = jens.consensus_from_poar(
        type(jm).from_sequences([r.replace("-", "") for r in rows[0]]),
        str(a), 2)
    assert out.aligned_rows() == [s.seq for s in ref.sequences]
    assert np.array_equal(out.col_confidence, ref.col_confidence)


def test_distributed_ensemble_matches_sequential(tmp_path):
    """Worker / merge (2 workers, 3 runs) reproduce the sequential
    ensemble, and the port's partial files merge in kalign_tpu."""
    seqs, names = _seqs()
    whole = tens.ensemble_align(Msa.from_sequences(seqs, names), n_runs=3,
                                consistency_anchors=5, engine="host")
    scratch = str(tmp_path / "ens")
    for w in range(2):
        tens.ensemble_worker(Msa.from_sequences(seqs, names), w, 2, scratch,
                             n_runs=3, consistency_anchors=5, engine="host")
    merged = tens.ensemble_merge(Msa.from_sequences(seqs, names), scratch,
                                 n_runs=3, consistency_anchors=5,
                                 engine="host")
    assert merged.aligned_rows() == whole.aligned_rows()
    assert np.array_equal(merged.col_confidence, whole.col_confidence)
    ref = jens.ensemble_merge(
        jio.read_alignment(os.path.join(DATA, "small.fa")), scratch,
        n_runs=3, consistency_anchors=5, engine="host")
    assert [s.seq for s in ref.sequences] == whole.aligned_rows()


ARGVS = [
    ["-i", "x.fa", "--precise"],
    ["-i", "x.fa", "--fast", "--ensemble"],
    ["-i", "x.fa", "--ensemble", "4", "--ensemble-seed", "7",
     "--min-support", "2", "--save-poar", "p.bin"],
    ["x.fa", "--load-poar", "p.bin", "-f", "sto", "-o", "o.sto"],
    ["-i", "x.fa", "--ensemble", "3", "--ensemble-scratch", "d",
     "--ensemble-worker", "1", "--ensemble-workers", "2"],
    ["-i", "x.fa", "--ensemble", "3", "--ensemble-scratch", "d",
     "--ensemble-merge"],
    ["-i", "x.fa", "--realign", "2", "--save-checkpoint", "c",
     "--adaptive-budget", "-n", "4", "--set", "3", "--refine", "confident"],
    ["-i", "x.fa", "--resume-checkpoint", "c", "--consistency", "3",
     "--vsm-amax", "1.5", "--type", "pfasum60", "--precise", "--realign",
     "2"],
    ["--showw"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_flags_parse_as_the_reference(argv):
    """Every flag the port shares with kalign_tpu/cli.py parses to the
    same value, and the mode presets resolve alike (cli.py:195-203)."""
    t = vars(tcli.build_parser().parse_args(argv))
    j = vars(jcli.build_parser().parse_args(argv))
    shared = (set(t) & set(j)) - {"engine"}  # gpu-fast | gpu | host here
    assert shared >= {"ensemble", "ensemble_seed", "ensemble_scratch",
                      "ensemble_worker", "ensemble_workers",
                      "ensemble_merge", "min_support", "save_poar",
                      "load_poar", "save_checkpoint", "resume_checkpoint",
                      "precise", "realign", "nthreads", "param_set",
                      "showw", "adaptive_budget", "format"}
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    args = tcli.build_parser().parse_args(argv)
    consistency, ensemble, realign = tcli.resolve_modes(args)
    want = (args.consistency, args.ensemble, args.realign)
    if args.fast and want[0] == 5:
        want = (0,) + want[1:]
    if args.precise:
        want = (want[0], want[1] or 3, want[2] or 1)
    assert (consistency, ensemble, realign) == want


def test_cli_showw_prints_the_reference_text(capsys):
    assert jcli.main(["--showw"]) == 0
    ref = capsys.readouterr().out
    assert tcli.main(["--showw"]) == 0
    assert capsys.readouterr().out == ref


def test_cli_precise_and_poar_files_match_the_reference(tmp_path):
    """--precise -f sto and --save-poar on the host engine give
    kalign_tpu's CLI bytes; --load-poar re-thresholds alike."""
    inp = os.path.join(DATA, "small.fa")
    files = {}
    for who, main in (("port", tcli.main), ("ref", jcli.main)):
        out, poar = tmp_path / f"{who}.sto", tmp_path / f"{who}.poar"
        assert main(["-i", inp, "-o", str(out), "-f", "sto", "--precise",
                     "--save-poar", str(poar), "--engine", "host",
                     "-q"]) == 0
        again = tmp_path / f"{who}.load.afa"
        assert main(["-i", inp, "-o", str(again), "--load-poar", str(poar),
                     "--engine", "host", "-q"]) == 0
        files[who] = (out.read_text(), poar.read_bytes(), again.read_text())
    assert files["port"] == files["ref"]
    assert "#=GC PP_cons" in files["port"][0]


def test_precise_mode_resolves_as_the_reference():
    from kalign_tpu import api as japi
    from kalign_tpu_torch import api as tapi
    for mode in (None, "default", "fast", "precise"):
        for ens, re in ((0, 0), (5, 0), (0, 2)):
            assert tapi._resolve_mode(mode, None, ens, re) == \
                japi._resolve_mode(mode, None, ens, re)
    with pytest.raises(ValueError):
        tapi._resolve_mode("quick", None, 0, 0)


def test_engine_entry_points_take_adaptive_budget():
    """--adaptive-budget reaches the native runtime of "host"; "gpu-fast"
    ignores it, as kalign_tpu's "tpu-fast" does."""
    m = _read(tio, "BB11001.tfa")
    a = TE.align_msa(m, consistency_anchors=5, engine="host",
                     adaptive_budget=1)
    ref = jio.read_inputs([os.path.join(DATA, "BB11001.tfa")])
    ref.quiet = True
    from kalign_tpu import engine as JE
    ref = JE.align_msa(ref, consistency_anchors=5, engine="host",
                       adaptive_budget=1)
    assert tio.write_fasta(a) == jio.write_fasta(ref)
