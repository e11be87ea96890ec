"""kalignfmt of kalign_tpu_torch (reformat.py) against kalign_tpu's: the
same arguments give the same bytes and return codes (--rename,
--unalign, --clean, fasta / msf / clu conversion, unaligned input to an
MSA format, no input)."""

import os

import pytest

from kalign_tpu import reformat as jfmt
from kalign_tpu_torch import reformat as tfmt

from conftest import DATA, GOLDEN

DUPS = (">a\nACDEFGHIK\n>b\nACDEGHIK\n>a\nACDFGHIKL\n>c\nACDEFGHK\n"
        ">b\nACDEFGHIKK\n")


def _run(main, tmp_path, sub, args, monkeypatch, capsys):
    """main(args) in tmp_path/sub (the output name, written into an MSF
    header, is the same in both); (rc, output bytes or None, stdout,
    stderr)."""
    d = tmp_path / sub
    os.makedirs(d)
    monkeypatch.chdir(d)
    (d / "dups.fa").write_text(DUPS)
    rc = main(args)
    cap = capsys.readouterr()
    out = (d / "out").read_bytes() if (d / "out").exists() else None
    return rc, out, cap.out, cap.err


@pytest.mark.parametrize("args", [
    ["-i", os.path.join(DATA, "BB11001.msf"), "-o", "out"],
    ["-i", os.path.join(DATA, "BB11001.msf"), "-o", "out", "--rename"],
    ["-i", os.path.join(DATA, "BB12006.msf"), "-o", "out", "--unalign"],
    ["-i", os.path.join(DATA, "BB12006.msf"), "-o", "out", "--unalign",
     "-f", "msf"],
    ["-i", "dups.fa", "-o", "out", "--clean"],
    ["-i", "dups.fa", "-o", "out", "--clean", "--rename"],
    ["-i", os.path.join(GOLDEN, "small.default.afa"), "-o", "out", "-f",
     "msf"],
    ["-i", os.path.join(GOLDEN, "small.default.afa"), "-o", "out", "-f",
     "clu"],
    ["-i", os.path.join(DATA, "BB30014.msf"), "-o", "out", "-f", "fasta"],
    [os.path.join(GOLDEN, "BB11001.default.clu"), "-o", "out", "-f",
     "msf"],
    ["-i", os.path.join(DATA, "small.fa"), "-o", "out", "-f", "msf"],
    ["-i", os.path.join(DATA, "small.fa"), "-o", "out"],
], ids=["msf-to-fasta", "rename", "unalign", "unalign-ignores-format",
        "clean", "clean-rename", "afa-to-msf", "afa-to-clu",
        "msf-to-fasta-long", "clu-to-msf", "unaligned-to-msf",
        "unaligned-to-fasta"])
def test_same_bytes_and_return_code(tmp_path, monkeypatch, capsys, args):
    t = _run(tfmt.main, tmp_path, "t", args, monkeypatch, capsys)
    j = _run(jfmt.main, tmp_path, "j", args, monkeypatch, capsys)
    assert t == j
    assert t[0] != 0 or t[1]


def test_no_input_prints_help_and_fails(tmp_path, monkeypatch, capsys):
    t = _run(tfmt.main, tmp_path, "t", [], monkeypatch, capsys)
    j = _run(jfmt.main, tmp_path, "j", [], monkeypatch, capsys)
    assert t[0] == j[0] == 1 and t[1] is None
    assert t[2].startswith("usage: kalignfmt-tpu-torch")
    assert j[2].startswith("usage: kalignfmt-tpu")


def test_clean_names_equal():
    from kalign_tpu.core import io as jio
    from kalign_tpu_torch.core import io as tio
    t = tfmt.clean_names(tio.read_alignment_text(DUPS))
    j = jfmt.clean_names(jio.read_alignment_text(DUPS))
    assert [s.name for s in t.sequences] == [s.name for s in j.sequences] \
        == ["a_2", "b_4", "a_1", "c", "b_3"]
