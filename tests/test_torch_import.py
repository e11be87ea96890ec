"""kalign_tpu_torch stands alone: it imports neither JAX nor kalign_tpu,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "kalign_tpu_torch")


def _forbidden(name: str) -> bool:
    return name in ("jax", "kalign_tpu") or name.startswith(
        ("jax.", "kalign_tpu."))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_import_leaves_jax_and_kalign_tpu_unloaded():
    code = ("import sys\n"
            "import kalign_tpu_torch, kalign_tpu_torch.cli, "
            "kalign_tpu_torch.gpu.engine, kalign_tpu_torch.gpu.distances, "
            "kalign_tpu_torch.gpu.exact, kalign_tpu_torch.gpu.exact_sweep, "
            "kalign_tpu_torch.ensemble, kalign_tpu_torch.consensus, "
            "kalign_tpu_torch.poar, kalign_tpu_torch.checkpoint, "
            "kalign_tpu_torch.io, kalign_tpu_torch.utils.rng, "
            "kalign_tpu_torch.serve, kalign_tpu_torch.warmup, "
            "kalign_tpu_torch.reformat, kalign_tpu_torch.dssim, "
            "kalign_tpu_torch.core.cmp, kalign_tpu_torch.utils.devtime, "
            "kalign_tpu_torch.parallel.mesh, "
            "kalign_tpu_torch.parallel.distributed, "
            "kalign_tpu_torch.gpu.gotoh_mesh, kalign_tpu_torch.gpu.gotoh_wave, "
            "kalign_tpu_torch.gpu.prepare\n"
            "kalign_tpu_torch.align, kalign_tpu_torch.compare\n"
            "kalign_tpu_torch.native.lib().kt_consensus_columns\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kalign_tpu') "
            "or m.startswith(('jax.', 'kalign_tpu.'))]\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_no_jax_or_kalign_tpu_import_in_port_sources():
    files = _port_files()
    names = {os.path.relpath(f, PKG) for f in files}
    assert {"ensemble.py", "consensus.py", "poar.py", "checkpoint.py",
            "io.py", os.path.join("utils", "rng.py"), "serve.py",
            "warmup.py", "reformat.py", "dssim.py", os.path.join("core",
                                                                 "cmp.py"),
            os.path.join("utils", "devtime.py"),
            os.path.join("utils", "__init__.py"),
            os.path.join("parallel", "mesh.py"),
            os.path.join("parallel", "distributed.py"),
            os.path.join("gpu", "gotoh_mesh.py"),
            os.path.join("gpu", "gotoh_wave.py"),
            os.path.join("gpu", "prepare.py")} <= names
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _forbidden(name), (path, node.lineno, name)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    import kalign_tpu_torch
    from kalign_tpu_torch import engine as E
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = ["MKVLAAGIVGLLLAA", "MKVLSAGIVGLLAA", "MKILAAGVVGLLLA"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kalign_tpu_torch.align(seqs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.resolve_device("cuda")
    rows = kalign_tpu_torch.align(seqs, device="cpu")
    assert [r.replace("-", "") for r in rows] == seqs
    assert len({len(r) for r in rows}) == 1


def test_unported_options_raise():
    """What the port does not run raises: an unknown mode, and an engine
    that is not one of its own (kalign_tpu's name "tpu-mesh"; the port's
    multi-GPU engine is "gpu-mesh", which aligns, here on two CPU
    shards).  Engine "auto" is ported: it aligns, on the CPU through
    "host", and records its choice.  Realign, checkpoints, tree noise and
    mode "precise" are ported: they align."""
    import kalign_tpu_torch
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch.core.msa import Msa
    seqs = ["MKVLAAGIVGLLLAA", "MKVLSAGIVGLLAA", "MKILAAGVVGLLLA"]
    with pytest.raises(ValueError):
        kalign_tpu_torch.align(seqs, mode="quick", device="cpu")
    with pytest.raises(ValueError):
        kalign_tpu_torch.align(seqs, engine="tpu-mesh", device="cpu")
    from kalign_tpu_torch.parallel.mesh import make_mesh
    mesh_eng = E.get_engine("gpu-mesh", mesh=make_mesh(devices=["cpu"] * 2))
    msa = kalign_tpu_torch.align_msa(seqs, engine=mesh_eng)
    assert msa.engine_stats["engine"] == "gpu-mesh"
    assert msa.engine_stats["shards"] == 2
    assert [r.replace("-", "") for r in msa.aligned_rows()] == seqs
    msa = kalign_tpu_torch.align_msa(seqs, engine="auto", device="cpu")
    assert msa.engine_stats["engine"] == "host"
    assert [r.replace("-", "") for r in msa.aligned_rows()] == seqs
    rows = kalign_tpu_torch.align(seqs, mode="precise", device="cpu")
    assert [r.replace("-", "") for r in rows] == seqs
    for kw in (dict(realign=1), dict(tree_seed=3, tree_noise=0.1),
               dict(refine=1)):
        m = Msa.from_sequences(seqs)
        m.quiet = True
        out = E.align_msa(m, device="cpu", **kw)
        assert [r.replace("-", "") for r in out.aligned_rows()] == seqs


def test_a_server_client_imports_no_torch():
    """The CLI parses its flags and forwards a --server call without the
    aligner's modules: a call to the warm server does not pay the torch
    import, nor does importing the package."""
    code = ("import sys\n"
            "import kalign_tpu_torch\n"
            "from kalign_tpu_torch import cli, serve\n"
            "serve.request = lambda sock, argv: {'rc': 0, 'error': None}\n"
            "rc = cli.main(['--server=/nonexistent.sock', '-i', 'x.fa'])\n"
            "print(rc, 'torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["0", "False"]


def test_wrappers_take_plain_versions_on_cpu_without_launching():
    """A CPU tensor runs the plain version; the launch counters count
    kernel launches only."""
    import numpy as np
    from kalign_tpu_torch.gpu import bpm, gotoh_lanewise, gotoh_row, scan
    from kalign_tpu_torch.gpu import traceback as tb
    from kalign_tpu_torch.gpu import gotoh_fused
    mods = (bpm, gotoh_fused, gotoh_lanewise, gotoh_row, scan, tb)
    before = [m.launches for m in mods]
    rng = np.random.default_rng(0)
    B, L1p, L2p = 4, 8, 8
    match = torch.from_numpy(rng.normal(size=(B, L1p, L2p)).astype(np.float32))
    pc = torch.full((B, 3, L2p + 1), -1.0)
    pr = torch.full((B, 3, L1p + 1), -1.0)
    la = torch.tensor([8, 3, 5, 1], dtype=torch.int32)
    lb = torch.tensor([8, 7, 2, 4], dtype=torch.int32)
    dec, score, st = gotoh_row.forward(match, pc, pr, la, lb)
    tb.walk_rows(dec, la, lb, st, L1p + L2p + 2)
    dec, score, st = gotoh_lanewise.forward(match, pc, pr, la, lb)
    tb.walk_lanewise(dec, la, lb, st, L1p + L2p + 2)
    ops = torch.from_numpy(rng.normal(size=(B, L1p, 5)).astype(np.float32))
    gotoh_fused.forward(ops, ops, pc, pr, la, lb)
    assert [m.launches for m in mods] == before
