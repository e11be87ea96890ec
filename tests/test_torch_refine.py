"""Refinement in the port on the CPU: the SP scorer and gap counts of the
host pass (gpu/profile.py) bitwise against kalign_tpu/tpu/profile.py,
the resident pass's device versions (gpu/resident.py::sp_scores,
node_gap_counts) against kalign_tpu/tpu/resident.py's, whole alignments
with refine = all / confident / inline three ways (resident pass,
host-assembled pass, kalign_tpu tpu-fast with and without its resident
pass), and the API and CLI with refinement and the scoring flags."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu.core import params as JP
from kalign_tpu.tpu import profile as JPR
from kalign_tpu.tpu import resident as JR
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core import params as TP
from kalign_tpu_torch.gpu import profile as TPR
from kalign_tpu_torch.gpu import resident as R
from kalign_tpu_torch.gpu.engine import GpuEngine, terminal_mask

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODES = {"all": TP.REFINE_ALL, "confident": TP.REFINE_CONFIDENT,
         "inline": TP.REFINE_INLINE}


def _random_merges(seed, B=6, L1p=48, L2p=56):
    """Random valid paths, profiles and gap states (the case of
    tests/test_resident.py::test_sp_scores_device_matches_host)."""
    rng = np.random.default_rng(seed)
    S = L1p + L2p + 2
    subm = rng.normal(scale=2.0, size=(23, 23)).astype(np.float32)
    subm = (subm + subm.T) / 2
    steps = np.full((B, S), 3, np.int8)
    nsteps = np.zeros(B, np.int32)
    r_counts = np.zeros((B, L1p, 23), np.float32)
    c_counts = np.zeros((B, L2p, 23), np.float32)
    gaps_r = np.zeros((B, L1p), np.int32)
    gaps_c = np.zeros((B, L2p), np.int32)
    nsip_r = rng.integers(1, 6, size=B).astype(np.int32)
    nsip_c = rng.integers(1, 6, size=B).astype(np.int32)
    for k in range(B):
        la = int(rng.integers(8, L1p))
        lb = int(rng.integers(8, L2p))
        m = int(rng.integers(1, min(la, lb)))
        path = [0] * m + [1] * (lb - m) + [2] * (la - m)
        rng.shuffle(path)
        steps[k, :len(path)] = path
        nsteps[k] = len(path)
        r_counts[k, :la] = rng.random((la, 23)).astype(np.float32) * nsip_r[k]
        c_counts[k, :lb] = rng.random((lb, 23)).astype(np.float32) * nsip_c[k]
        gaps_r[k, :la] = rng.integers(0, nsip_r[k] + 1, size=la)
        gaps_c[k, :lb] = rng.integers(0, nsip_c[k] + 1, size=lb)
    return dict(steps=steps, nsteps=nsteps, r_counts=r_counts,
                c_counts=c_counts, gaps_r=gaps_r, gaps_c=gaps_c,
                nsip_r=nsip_r, nsip_c=nsip_c, subm=subm, L1p=L1p, L2p=L2p,
                S=S)


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_sp_score_from_profiles_is_kalign_tpus(seed):
    """The host pass's float64 scorer, bitwise, on random paths."""
    c = _random_merges(seed)
    gpo, gpe, tgpe = 5.5, 2.0, 1.0
    for k in range(len(c["nsteps"])):
        st = c["steps"][k, :c["nsteps"][k]]
        la = int(np.sum(st != 1))
        lb = int(np.sum(st != 2))
        args = []
        for mod in (TPR, JPR):
            pa = mod.Profile(counts=c["r_counts"][k, :la],
                             subrows=c["r_counts"][k, :la],
                             pen=np.zeros((la + 2, 3), np.float32))
            pb = mod.Profile(counts=c["c_counts"][k, :lb],
                             subrows=c["c_counts"][k, :lb],
                             pen=np.zeros((lb + 2, 3), np.float32))
            args.append((pa, pb))
        rest = (st, terminal_mask(st), int(c["nsip_r"][k]),
                int(c["nsip_c"][k]), c["gaps_r"][k, :la].astype(np.int64),
                c["gaps_c"][k, :lb].astype(np.int64), c["subm"], gpo, gpe,
                tgpe)
        got = TPR.sp_score_from_profiles(*args[0], *rest)
        want = JPR.sp_score_from_profiles(*args[1], *rest)
        assert np.float64(got).view(np.int64) == \
            np.float64(want).view(np.int64)


def _gap_state(seed=9, n=7, Lg=30):
    """The mid-alignment gap state of
    tests/test_resident.py::test_node_gap_counts_device_matches_host."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, Lg - 1, size=n).astype(np.int32)
    gaps = []
    gaps_buf = np.zeros((n, Lg), np.int32)
    for i in range(n):
        g = rng.integers(0, 3, size=lens[i] + 1).astype(np.int64)
        gaps.append(g.tolist())
        gaps_buf[i, :lens[i] + 1] = g
    nodes = [[0, 1, 2], [3, 4], [6]]
    Lp = 1 + max(int(np.max(np.cumsum(np.asarray(gaps[i][:-1]) + 1) - 1))
                 for i in range(n))
    return lens, gaps, gaps_buf, nodes, Lp


def test_column_gap_counts_is_kalign_tpus():
    lens, gaps, _, nodes, Lp = _gap_state()
    for mem in nodes:
        got = TPR.column_gap_counts(Lp, len(mem), mem, lens, gaps)
        want = JPR.column_gap_counts(Lp, len(mem), mem, lens, gaps)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_node_gap_counts_matches_kalign_tpu():
    """Residues per column from the resident gap state: exactly
    _node_gap_counts_device's, and the host pass's gap counts."""
    lens, gaps, gaps_buf, nodes, Lp = _gap_state()
    mem_seq = np.array([m for mem in nodes for m in mem], np.int32)
    mem_node = np.array([k for k, mem in enumerate(nodes) for _ in mem],
                        np.int32)
    want = np.asarray(JR._node_gap_counts_device(
        jnp.asarray(gaps_buf), jnp.asarray(lens), jnp.asarray(mem_seq),
        jnp.asarray(mem_node), n_nodes=len(nodes), Lp=Lp))
    got = R.node_gap_counts(torch.from_numpy(gaps_buf),
                            torch.from_numpy(lens),
                            torch.from_numpy(mem_seq).long(),
                            torch.from_numpy(mem_node).long(), len(nodes),
                            Lp).numpy()
    assert np.array_equal(got, want)
    for k, mem in enumerate(nodes):
        assert np.array_equal(len(mem) - got[k], TPR.column_gap_counts(
            Lp, len(mem), mem, lens, gaps))


@pytest.mark.parametrize("seed", [41, 42])
def test_sp_scores_matches_kalign_tpu(seed):
    """The resident pass's float32 scorer within rel 1e-5 of _sp_scores
    (both float32, summed in their own orders)."""
    c = _random_merges(seed)
    B = len(c["nsteps"])
    base_pen = np.tile(np.array([5.5, 2.0, 1.0], np.float32), (B, 1))
    want = np.asarray(JR._sp_scores(
        jnp.asarray(c["steps"]), jnp.asarray(c["nsteps"]),
        jnp.asarray(c["r_counts"]), jnp.asarray(c["c_counts"]),
        jnp.asarray(c["gaps_r"]), jnp.asarray(c["gaps_c"]),
        jnp.asarray(c["nsip_r"]), jnp.asarray(c["nsip_c"]),
        jnp.asarray(c["subm"]), jnp.asarray(base_pen), c["L1p"], c["L2p"],
        c["S"]))
    t = torch.from_numpy
    got = R.sp_scores(t(c["steps"]), t(c["nsteps"]), t(c["r_counts"]),
                      t(c["c_counts"]), t(c["gaps_r"]), t(c["gaps_c"]),
                      t(c["nsip_r"]), t(c["nsip_c"]), t(c["subm"]),
                      t(base_pen), c["L1p"], c["L2p"]).numpy()
    assert got.dtype == np.float32
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)), (got, want)


def test_select_paths_takes_the_first_best_and_flags_disagreement():
    steps = [torch.tensor([[0, 0, 3], [0, 1, 2]], dtype=torch.int8),
             torch.tensor([[0, 0, 1], [0, 1, 2]], dtype=torch.int8),
             torch.tensor([[1, 2, 0], [0, 1, 2]], dtype=torch.int8)]
    n = [torch.tensor([2, 3]), torch.tensor([2, 3]), torch.tensor([3, 3])]
    sp = torch.tensor([[1.0, 2.0], [1.0, 2.0], [0.5, 2.0]])
    sel, n_sel, best_sp, multi, best = R.select_paths(list(zip(steps, n)),
                                                     sp)
    assert best.tolist() == [0, 0]
    assert multi.tolist() == [True, False]     # candidate 1 = candidate 0
    assert best_sp.tolist() == [1.0, 2.0] and n_sel.tolist() == [2, 3]
    sp = torch.tensor([[1.0, 2.0], [1.5, 2.0], [1.5, 3.0]])
    sel, n_sel, _, _, best = R.select_paths(list(zip(steps, n)), sp)
    assert best.tolist() == [1, 2]
    assert sel[0, :2].tolist() == [0, 0] and n_sel.tolist() == [2, 3]


def _port(path, consistency, mode, resident):
    m = tio.read_alignment(path)
    m.quiet = True
    eng = GpuEngine("cpu", resident=resident)
    return TE.align_msa(m, consistency_anchors=consistency, refine=mode,
                        engine=eng, autoroute=False)


def _jax(path, consistency, mode, resident, monkeypatch):
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    if resident:
        monkeypatch.delenv("KALIGN_TPU_NO_RESIDENT", raising=False)
    else:
        monkeypatch.setenv("KALIGN_TPU_NO_RESIDENT", "1")
    m = jio.read_alignment(path)
    m.quiet = True
    return JE.align_msa(m, consistency_anchors=consistency, refine=mode,
                        engine="tpu-fast")


def _same_bytes_four_ways(case, consistency, name, monkeypatch):
    path = os.path.join(DATA, case + ".tfa")
    mode = MODES[name]
    res = _port(path, consistency, mode, True)
    host = _port(path, consistency, mode, False)
    want = tio.format_alignment(res, "fasta")
    assert tio.format_alignment(host, "fasta") == want
    for resident in (True, False):
        ref = _jax(path, consistency, mode, resident, monkeypatch)
        assert jio.format_alignment(ref, "fasta") == want, resident
    # the resident pass fetches once per level and once at the end, per
    # pass (confident runs two)
    st = res.engine_stats
    passes = 2 if mode == TP.REFINE_CONFIDENT else 1
    assert st["fetches"] == len(st["levels"]) + passes
    return res, host


@pytest.mark.parametrize("case", ["BB11001", "BB12006"])
@pytest.mark.parametrize("name", ["all", "confident", "inline"])
def test_refine_fast_mode_same_bytes_three_ways(case, name, monkeypatch):
    """refine = all / confident / inline in --fast mode: the resident pass,
    the host-assembled pass and kalign_tpu tpu-fast (resident and not)
    give the same FASTA; both passes choose the same candidates."""
    res, host = _same_bytes_four_ways(case, 0, name, monkeypatch)
    cr = res.engine_stats["candidates"]
    ch = host.engine_stats["candidates"]
    assert set(cr) == set(ch)
    if name != "confident":
        assert len(cr) == len(res.task_confidence)
    for t in cr:
        assert cr[t][0] == ch[t][0]
        assert np.allclose(cr[t][1], ch[t][1], rtol=1e-5, atol=0)
    if name == "confident":
        assert res.engine_stats["refine_flagged"] == \
            host.engine_stats["refine_flagged"]


def test_refine_confident_default_mode_same_bytes(monkeypatch):
    """refine = confident with anchor consistency (K = 5) on BB11001: the
    bonus goes through both the probe and the replay alike."""
    _same_bytes_four_ways("BB11001", 5, "confident", monkeypatch)


def test_api_and_cli_take_refine(tmp_path):
    import kalign_tpu_torch
    from kalign_tpu_torch import api, cli
    path = os.path.join(DATA, "BB11001.tfa")
    msa = tio.read_alignment(path)
    seqs = [s.seq for s in msa.sequences]
    names = [s.name for s in msa.sequences]
    ref = kalign_tpu_torch.align_msa(seqs, names=names, mode="fast",
                                     refine="all", device="cpu")
    assert ref.engine_stats["candidates"]
    rows = kalign_tpu_torch.align(seqs, mode="fast", refine=TP.REFINE_ALL,
                                  device="cpu")
    assert rows == ref.aligned_rows()
    out = tmp_path / "out.afa"
    assert cli.main(["-i", path, "-o", str(out), "--fast", "--refine", "all",
                     "--device", "cpu", "-q"]) == 0
    assert out.read_text() == tio.format_alignment(ref, "fasta")
    # the CLI parses as kalign_tpu's does: "inline" is none there
    assert cli._resolve_refine("inline") == TP.REFINE_NONE
    assert cli._resolve_refine("confident") == TP.REFINE_CONFIDENT
    assert cli._resolve_refine(None) == TP.REFINE_NONE
    assert api._resolve_refine("inline") == TP.REFINE_INLINE
    with pytest.raises(ValueError):
        kalign_tpu_torch.align(seqs, refine="sometimes", device="cpu")


def test_cli_scoring_flags_match_kalign_tpu(tmp_path, monkeypatch):
    """--gpo 5 --gpe 1 on BB11001: kalign_tpu's FASTA (tpu-fast, without
    the divergent-family autoroute), through both CLIs; the API's
    gap_open / gap_extend give the same rows, and --type reaches the
    scoring model."""
    import kalign_tpu_torch
    from kalign_tpu import cli as jcli
    from kalign_tpu_torch import cli
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    path = os.path.join(DATA, "BB11001.tfa")
    got, want = tmp_path / "t.afa", tmp_path / "j.afa"
    assert cli.main(["-i", path, "-o", str(got), "--gpo", "5", "--gpe", "1",
                     "--device", "cpu", "-q"]) == 0
    assert jcli.main(["-i", path, "-o", str(want), "--gpo", "5", "--gpe",
                      "1", "--engine", "tpu-fast", "-q"]) == 0
    assert got.read_text() == want.read_text()
    plain = tmp_path / "p.afa"
    assert cli.main(["-i", path, "-o", str(plain), "--device", "cpu",
                     "-q"]) == 0
    assert plain.read_text() != got.read_text()
    msa = tio.read_alignment(path)
    api_msa = kalign_tpu_torch.align_msa(
        [s.seq for s in msa.sequences], names=[s.name for s in msa.sequences],
        gap_open=5, gap_extend=1, seq_type="protein", device="cpu")
    assert tio.format_alignment(api_msa, "fasta") == got.read_text()
    assert cli._resolve_type("pfasum60") == TP.KALIGN_TYPE_PROTEIN_PFASUM60
    assert JP.KALIGN_TYPE_PROTEIN_PFASUM60 == TP.KALIGN_TYPE_PROTEIN_PFASUM60
