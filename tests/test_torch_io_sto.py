"""Stockholm output of kalign_tpu_torch against kalign_tpu's: the writer
(io.write_stockholm) and core/io.py's "sto" format, with and without the
ensemble's confidences, byte for byte."""

import io
import os

import numpy as np
import pytest

from kalign_tpu import io as jkio
from kalign_tpu import ensemble as jens
from kalign_tpu.core import io as jio
from kalign_tpu_torch import io as tkio
from kalign_tpu_torch import ensemble as tens
from kalign_tpu_torch.core import io as tio

from conftest import DATA, GOLDEN

ROWS = ["AC-DEF", "ACGD-F", "-CGDEF"]
IDS = ["seq_one", "s2", "a_longer_name"]


def _text(writer, **kw):
    buf = io.StringIO()
    writer(ROWS, buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kw", [
    {},
    dict(ids=IDS),
    dict(ids=IDS, column_confidence=np.array([1.0, 0.5, 0.96, 0.0, 0.949,
                                              0.31], np.float32)),
    dict(ids=IDS, column_confidence=[0.2] * 6,
         residue_confidence=[[0.99, 0.5, 0.0, 0.1, 0.2, 0.95]] * 3),
], ids=["no-ids", "ids", "column-confidence", "residue-confidence"])
def test_writer_text_equal(kw):
    assert _text(tkio.write_stockholm, **kw) == _text(jkio.write_stockholm,
                                                      **kw)


def test_writer_checks_ids():
    with pytest.raises(ValueError):
        _text(tkio.write_stockholm, ids=IDS[:2])
    with pytest.raises(ValueError):
        tkio.write_stockholm([], io.StringIO())


def test_sto_format_of_an_alignment_without_confidence():
    """col_confidence stays None outside the ensemble: no PP lines."""
    t = tio.read_alignment(os.path.join(GOLDEN, "BB11001.default.afa"))
    j = jio.read_alignment(os.path.join(GOLDEN, "BB11001.default.afa"))
    for m in (t, j):
        if m.aligned == 2:
            m.finalise()
    out = tio.format_alignment(t, "sto")
    assert out == jio.format_alignment(j, "sto")
    assert " PP " not in out and "PP_cons" not in out
    assert out.startswith("# STOCKHOLM 1.0\n")


def test_sto_format_of_an_ensemble_with_confidence():
    """The ensemble's residue and column confidences as #=GR PP and
    #=GC PP_cons lines, the same text from both packages."""
    def run(mod, ens):
        m = mod.read_inputs([os.path.join(DATA, "tiny.fa")])
        m.quiet = True
        return ens.ensemble_align(m, n_runs=3, consistency_anchors=5,
                                  engine="host")
    t, j = run(tio, tens), run(jio, jens)
    out = tio.format_alignment(t, "sto")
    assert out == jio.format_alignment(j, "sto")
    assert "#=GC PP_cons" in out and "#=GR " in out


def test_cli_writes_stockholm(tmp_path):
    from kalign_tpu_torch import cli
    out = tmp_path / "o.sto"
    assert cli.main(["-i", os.path.join(DATA, "tiny.fa"), "-o", str(out),
                     "-f", "sto", "--engine", "host", "-q"]) == 0
    m = tio.read_inputs([os.path.join(DATA, "tiny.fa")])
    m.quiet = True
    from kalign_tpu_torch import engine as TE
    ref = TE.align_msa(m, consistency_anchors=5, engine="host")
    assert out.read_text() == tio.format_alignment(ref, "sto")
