"""kalign_tpu_torch's python-kalign surface against kalign_tpu's on the same
inputs: the DSSim simulator (identical sequences, names and gold rows),
the comparison metrics (bitwise-equal floats), the alignment utilities,
the file API on the host engine (identical bytes), ids= and fmt=, the
thread default, and engine "auto" (host on the CPU, kalign_tpu's auto
bytes)."""

import os

import numpy as np
import pytest
import torch

import kalign_tpu as J
from kalign_tpu import api as japi
from kalign_tpu import cli as jcli
from kalign_tpu import dssim as jdssim
from kalign_tpu import utils as jutils
import kalign_tpu_torch as T
from kalign_tpu_torch import api as tapi
from kalign_tpu_torch import cli as tcli
from kalign_tpu_torch import dssim as tdssim
from kalign_tpu_torch import engine as tE
from kalign_tpu_torch import utils as tutils
from kalign_tpu_torch.core.msa import Msa

from conftest import DATA, GOLDEN

FAMILIES = ["BB11001", "BB12006", "BB30014"]
SEQS = ["MKVLAAGIVGLLLAA", "MKVLSAGIVGLLAA", "MKILAAGVVGLLLA",
        "MKVLAAGIVALLLAA"]


@pytest.mark.parametrize("n_seq,n_obs,dna,length,seed", [
    (20, 10, False, 100, 1), (30, 5, True, 80, 42), (120, 10, False, 60, 7),
    (8, 3, True, 200, 0)])
def test_dssim_sequences_equal(n_seq, n_obs, dna, length, seed):
    got = tdssim.generate_test_sequences(n_seq, n_obs, dna, length, seed)
    want = jdssim.generate_test_sequences(n_seq, n_obs, dna, length, seed)
    assert got == want
    assert T.generate_test_sequences(n_seq, n_obs, dna, length, seed) \
        == J.generate_test_sequences(n_seq, n_obs, dna, length, seed)


@pytest.mark.parametrize("kw", [
    dict(n_seq=12, seed=3), dict(n_seq=10, dna=True, length=90, seed=5),
    dict(n_seq=15, n_obs=4, length=70, seed=9, indel_p=0.1,
         match_err_p=0.2, insert_err_p=0.4)])
def test_dssim_alignment_equal(kw):
    assert tdssim.generate_test_alignment(**kw) \
        == jdssim.generate_test_alignment(**kw)


def _gold_and_test(name):
    return (os.path.join(DATA, f"{name}.msf"),
            os.path.join(GOLDEN, f"{name}.default.afa"))


@pytest.mark.parametrize("name", FAMILIES)
def test_compare_floats_equal(name):
    ref, test = _gold_and_test(name)
    got = T.compare(ref, test)
    assert isinstance(got, float) and got == J.compare(ref, test)
    for kw in ({}, dict(max_gap_frac=0.2), dict(max_gap_frac=-1.0)):
        assert vars(T.compare_detailed(ref, test, **kw)) \
            == vars(J.compare_detailed(ref, test, **kw))


@pytest.mark.parametrize("name", FAMILIES)
def test_compare_with_mask_equal(name):
    ref, test = _gold_and_test(name)
    width = len(tapi._rows_arg(ref, None)[0][0])
    mask = (np.arange(width) % 3 != 0).astype(np.int32)
    assert vars(T.compare_with_mask(ref, test, mask)) \
        == vars(J.compare_with_mask(ref, test, mask))
    assert vars(T.compare_detailed(ref, test, column_mask=list(mask))) \
        == vars(J.compare_detailed(ref, test, column_mask=list(mask)))
    for api in (T, J):
        with pytest.raises(ValueError, match="Mask length"):
            api.compare_with_mask(ref, test, mask[:-1])


def test_compare_rows_with_names():
    rows_a = ["AC-DE", "ACGDE", "A-GDE"]
    rows_b = ["ACD-E", "ACGDE", "AG-DE"]
    names = ["x", "y", "z"]
    assert T.compare(rows_a, rows_b, names, names) \
        == J.compare(rows_a, rows_b, names, names)
    assert vars(T.compare_detailed(rows_a, rows_b)) \
        == vars(J.compare_detailed(rows_a, rows_b))


def _rows(name):
    return tapi._rows_arg(os.path.join(GOLDEN, f"{name}.default.afa"),
                          None)[0]


@pytest.mark.parametrize("name", FAMILIES + ["small"])
def test_utils_equal(name):
    rows = _rows(name)
    np.testing.assert_array_equal(tutils.to_array(rows),
                                  jutils.to_array(rows))
    assert tutils.alignment_stats(rows) == jutils.alignment_stats(rows)
    for th in (0.0, 0.5, 0.9, 1.0):
        assert tutils.consensus_sequence(rows, th) \
            == jutils.consensus_sequence(rows, th)
        assert tutils.remove_gap_columns(rows, th) \
            == jutils.remove_gap_columns(rows, th)
    np.testing.assert_array_equal(tutils.pairwise_identity_matrix(rows),
                                  jutils.pairwise_identity_matrix(rows))
    for start, end in ((None, None), (3, 40), (-30, -2), (None, -5)):
        assert tutils.trim_alignment(rows, start, end) \
            == jutils.trim_alignment(rows, start, end)


@pytest.mark.parametrize("call", [
    lambda u: u.to_array([]), lambda u: u.to_array(["AC", "A"]),
    lambda u: u.consensus_sequence([]),
    lambda u: u.consensus_sequence(["AC"], 1.5),
    lambda u: u.remove_gap_columns([]),
    lambda u: u.remove_gap_columns(["AC"], -0.1),
    lambda u: u.pairwise_identity_matrix([]),
    lambda u: u.trim_alignment([]),
    lambda u: u.trim_alignment(["ACGT"], 3, 2)])
def test_utils_errors_equal(call):
    for u in (tutils, jutils):
        with pytest.raises(ValueError):
            call(u)


@pytest.mark.parametrize("name", ["BB11001", "small"])
def test_align_from_file_equals_host(name):
    path = os.path.join(DATA, f"{name}.tfa" if name.startswith("BB")
                        else f"{name}.fa")
    assert T.align_from_file(path, engine="host") \
        == J.align_from_file(path, engine="host")
    assert T.align_from_file(path, engine="host", mode="fast") \
        == J.align_from_file(path, engine="host", mode="fast")


@pytest.mark.parametrize("fmt", ["fasta", "msf", "clu"])
def test_align_file_to_file_bytes(tmp_path, monkeypatch, fmt):
    """The same output name (MSF writes it into its header) in two
    directories."""
    inp = os.path.join(DATA, "BB12006.tfa")
    for api, d in ((T, "t"), (J, "j")):
        os.makedirs(tmp_path / d)
        monkeypatch.chdir(tmp_path / d)
        api.align_file_to_file(inp, "out", fmt, engine="host")
    assert (tmp_path / "t" / "out").read_bytes() \
        == (tmp_path / "j" / "out").read_bytes()


def test_read_and_write_alignment_bytes(tmp_path):
    path = os.path.join(DATA, "BB11001.msf")
    t, j = T.read_alignment(path), J.read_alignment(path)
    assert [(s.name, s.seq, s.gaps) for s in t.sequences] \
        == [(s.name, s.seq, s.gaps) for s in j.sequences]
    rows = _rows("BB11001")
    names = [f"s{i}" for i in range(len(rows))]
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    for fmt in ("fasta", "msf", "clu"):
        T.write_alignment(rows, str(tmp_path / "t" / "out"), fmt, names=names)
        J.write_alignment(rows, str(tmp_path / "j" / "out"), fmt, names=names)
        assert (tmp_path / "t" / "out").read_bytes() \
            == (tmp_path / "j" / "out").read_bytes()
    t = T.read_alignment(os.path.join(GOLDEN, "BB11001.default.afa"))
    t.finalise()
    T.write_alignment(t, str(tmp_path / "m.afa"))
    assert (tmp_path / "m.afa").read_bytes() == open(
        os.path.join(GOLDEN, "BB11001.default.afa"), "rb").read()


def test_ids_name_the_rows(monkeypatch):
    """ids= names the sequences when names= is not given (and names=
    wins over it), as kalign_tpu's align does; the adapter receives the
    names in input order."""
    seen = {}
    for api, key in ((tapi, "t"), (japi, "j")):
        monkeypatch.setattr(api, "_to_biopython", lambda msa, rows, names,
                            key=key: seen.setdefault(key, []).append(
                                (rows, names)))
    ids = ["a", "b", "c", "d"]
    for kw in (dict(ids=ids), dict(ids=ids, names=["w", "x", "y", "z"])):
        T.align(SEQS, fmt="biopython", engine="host", **kw)
        J.align(SEQS, fmt="biopython", engine="host", **kw)
    assert seen["t"] == seen["j"]
    assert seen["t"][0][1] == ids and seen["t"][1][1] == ["w", "x", "y", "z"]
    assert T.align(SEQS, ids=ids, engine="host") \
        == J.align(SEQS, ids=ids, engine="host")


def test_fmt_adapters_raise_the_reference_import_error():
    for fmt in ("biopython", "skbio"):
        errs = []
        for api in (T, J):
            with pytest.raises(ImportError) as e:
                api.align(SEQS, fmt=fmt, engine="host")
            errs.append(str(e.value))
        assert errs[0] == errs[1] and "pip install" in errs[0]
    with pytest.raises(ValueError, match="Unknown fmt"):
        T.align(SEQS, fmt="phylip", engine="host")


def test_conf_to_pp_agrees():
    for c in np.linspace(0.0, 1.0, 201):
        assert tapi._conf_to_pp(float(c)) == japi._conf_to_pp(float(c))


def test_set_num_threads_takes_effect(monkeypatch):
    seen = []
    orig = tE.align_msa

    def spy(msa, **kw):
        seen.append(kw["n_threads"])
        return orig(msa, **kw)
    monkeypatch.setattr(tE, "align_msa", spy)
    assert T.get_num_threads() == 1
    try:
        T.set_num_threads(3)
        assert T.get_num_threads() == 3
        T.align(SEQS, engine="host")
        T.align(SEQS, engine="host", n_threads=2)
    finally:
        T.set_num_threads(1)
    assert seen == [3, 2]
    with pytest.raises(ValueError):
        T.set_num_threads(0)


def test_auto_resolves_by_the_reference_policy(monkeypatch):
    small = Msa.from_sequences(SEQS)
    big = Msa.from_sequences(SEQS * 64)
    assert tE.resolve_auto_engine(big, "cpu") == "host"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tE.resolve_auto_engine(big) == "host"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tE.resolve_auto_engine(small) == "host"
    # several cards: kalign_tpu's "tpu-mesh" (engine.py:204)
    assert tE.resolve_auto_engine(big, "cuda") == "gpu-mesh"
    assert tE.resolve_auto_engine(None, torch.device("cuda")) == "gpu-mesh"
    assert tE.resolve_auto_engine(big, "cpu") == "host"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tE.resolve_auto_engine(big, "cuda") == "gpu-fast"
    assert tE.resolve_auto_engine(None, torch.device("cuda")) == "gpu-fast"


@pytest.mark.parametrize("name", ["BB11001.tfa", "small.fa"])
def test_auto_on_cpu_gives_the_reference_auto_bytes(tmp_path, name):
    inp = os.path.join(DATA, name)
    got, want = tmp_path / "t.afa", tmp_path / "j.afa"
    assert tcli.main(["-i", inp, "-o", str(got), "--engine", "auto",
                      "--device", "cpu", "-q"]) == 0
    assert jcli.main(["-i", inp, "-o", str(want), "--engine", "auto",
                      "-q"]) == 0
    assert got.read_bytes() == want.read_bytes()
    msa = T.align_msa(tapi._rows_arg(inp, None)[0], engine="auto",
                      device="cpu")
    assert msa.engine_stats["engine"] == "host"
