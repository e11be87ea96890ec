"""The divergent-family autoroute and the engines "gpu" and "host" of the
port on the CPU, against kalign_tpu (tests/test_autoroute_kmeans.py:15-91
for the reference's routing) and the golden files."""

import os

import pytest
import torch

from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu_torch import api
from kalign_tpu_torch import cli
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(HERE, "golden")


def _port(case, consistency, **kw):
    m = tio.read_alignment(os.path.join(DATA, case))
    m.quiet = True
    return TE.align_msa(m, consistency_anchors=consistency, device="cpu",
                        **kw)


def _jax_host(case, consistency):
    m = jio.read_alignment(os.path.join(DATA, case))
    m.quiet = True
    return jio.format_alignment(
        JE.align_msa(m, consistency_anchors=consistency, engine="host"),
        "fasta")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain sweep steps through small tensors: one intra-op thread
    is faster there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Routed(Exception):
    pass


@pytest.fixture
def spy_route(monkeypatch):
    """GpuExactEngine construction raises Routed: the routing decision
    alone, without the exact alignment."""
    def routed(*a, **k):
        raise Routed()
    monkeypatch.setattr(TE, "GpuExactEngine", routed)


def test_divergent_family_routes_to_the_exact_engine():
    """BB30014 (mean anchor distance ~0.55), --fast, default arguments:
    the gpu engine aligns, and its FASTA is kalign_tpu's host engine's,
    byte for byte; the guide tree is the one gpu-fast built, its spans
    and pair counts carried over."""
    out = _port("BB30014.tfa", 0)
    st = out.engine_stats
    assert st["engine"] == "gpu" and st["routed_from"] == "gpu-fast"
    assert st["mean_seq_distance"] > 0.5 and st["tree"] == "native"
    assert st["sweep_launches"] > 0 and st["sweep_steps"] > 0
    assert st["canary"]["path_equal"]
    assert set(out.phase_times) == {"input", "distances", "tree",
                                    "tree.splits", "tree.pairs",
                                    "tree.upgma", "progressive", "output",
                                    "unspanned"}
    assert st["tree_pairs_computed"] == st["tree_pairs_needed"] \
        == st["tree_pairs_batched"] > 0
    assert tio.format_alignment(out, "fasta") == _jax_host("BB30014.tfa", 0)


def test_close_family_does_not_route(monkeypatch):
    """BB12006 (mean distance ~0.40) stays on gpu-fast."""
    made = []
    real = TE.GpuExactEngine

    def spy(*a, **k):
        made.append(1)
        return real(*a, **k)
    monkeypatch.setattr(TE, "GpuExactEngine", spy)
    out = _port("BB12006.tfa", 0)
    assert out.engine_stats["engine"] == "gpu-fast" and not made


def test_autoroute_cap_and_opt_out(spy_route):
    """autoroute_max (KALIGN_TPU_AUTOROUTE_MAX, default 16,384) and
    autoroute=False (KALIGN_TPU_NO_AUTOROUTE) do what the reference's
    variables do: at the family's size the family routes, below it and
    with the opt-out it does not."""
    assert TE.AUTOROUTE_MAX == 16384
    with pytest.raises(Routed):
        _port("BB30014.tfa", 0, autoroute_max=44)
    for kw in (dict(autoroute_max=43), dict(autoroute=False)):
        out = _port("BB30014.tfa", 0, **kw)
        assert out.engine_stats["engine"] == "gpu-fast"
    with pytest.raises(Routed):
        api.align_msa([s.seq for s in tio.read_alignment(os.path.join(
            DATA, "BB30014.tfa")).sequences], mode="fast", device="cpu")


def test_exact_engine_gives_the_golden_bytes():
    """engine="gpu" on BB12006 in default mode: the golden file."""
    out = _port("BB12006.tfa", 5, engine="gpu")
    assert out.engine_stats["engine"] == "gpu"
    with open(os.path.join(GOLDEN, "BB12006.default.afa")) as fh:
        assert tio.format_alignment(out, "fasta") == fh.read()


def test_divergent_family_default_mode_gives_the_golden_bytes():
    """BB30014 in default mode with default arguments: routed, and the
    golden file (the consistency pre-pass's pairs through the packed
    sweep)."""
    out = _port("BB30014.tfa", 5)
    assert out.engine_stats["engine"] == "gpu"
    with open(os.path.join(GOLDEN, "BB30014.default.afa")) as fh:
        assert tio.format_alignment(out, "fasta") == fh.read()


def test_host_engine_and_cli_engine_flags(tmp_path):
    """--engine host is kalign_tpu's host engine on BB30014, in both
    modes; --no-autoroute keeps the family on gpu-fast (the API's
    autoroute=False rows); api.align takes the engine names."""
    path = os.path.join(DATA, "BB30014.tfa")
    out = tmp_path / "h.afa"
    for flags, consistency in (([], 5), (["--fast"], 0)):
        assert cli.main(["-i", path, "-o", str(out), "--engine", "host",
                         "-q", *flags]) == 0
        assert out.read_text() == _jax_host("BB30014.tfa", consistency)
    assert cli.main(["-i", path, "-o", str(out), "--fast", "--device",
                     "cpu", "--no-autoroute", "-q"]) == 0
    want = _port("BB30014.tfa", 0, autoroute=False)
    assert out.read_text() == tio.format_alignment(want, "fasta")
    msa = tio.read_alignment(path)
    seqs = [s.seq for s in msa.sequences]
    rows = api.align(seqs, mode="fast", engine="host")
    assert [r.replace("-", "") for r in rows] == seqs
    with pytest.raises(ValueError):
        api.align(seqs, engine="tpu")
    with pytest.raises(SystemExit):
        cli.main(["-i", path, "-o", str(out), "--engine", "tpu"])
