"""kalign_tpu_torch/parallel/distributed.py in real processes: local gloo
process groups (init_distributed), each process aligning its
my_ensemble_runs share, running its shards of one mesh that spans the
processes, or aligning a whole family on the engine "gpu-mesh" over such
a mesh; the results must be the one-process run's, byte for byte
(kalign_tpu's tests/test_distributed.py, on the port; the family as
kalign_tpu's "tpu-mesh" aligns it under jax.distributed).

The coordinator's port is chosen by process 0 itself (_RENDEZVOUS): it
binds port 0, keeps the socket (the rendezvous's store joins it) and
publishes the port in a file the others read.  A port chosen by the
parent and closed again before the children bind it could be taken by
any other process meanwhile (the suite runs in parallel workers, each
starting gloo groups and distributed JAX processes).  gloo binds the
loopback interface (GLOO_SOCKET_IFNAME=lo: the processes share one
machine; no host name is resolved), and every process leaves through a
barrier (_FAREWELL), so that none closes its connections, or process 0
its store, while another still reads from them.  A group whose processes
failed on the network (_NETWORK_ERRORS in their output) is run once more,
its first output printed; a wrong result is never run again."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.ensemble import ensemble_align, ensemble_merge
from kalign_tpu_torch.parallel import distributed as D
from kalign_tpu_torch.parallel import mesh as TM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
TIMEOUT_S = 300

# each child's first lines: its coordinator address.  Process 0 starts the
# store's server on a port the kernel assigns (no other process can take
# it from then on; init_process_group's tcp rendezvous, multi-tenant,
# joins that server) and publishes the port in argv[1]; the others wait
# for the file.
_RENDEZVOUS = r"""
import os, sys, time
from datetime import timedelta
import torch.distributed as _dist
_path, _pid, _nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
if _pid == 0:
    _server = _dist.TCPStore("127.0.0.1", 0, _nproc, True,
                             timedelta(seconds=%(timeout)d),
                             wait_for_workers=False, multi_tenant=True)
    with open(_path + ".tmp", "w") as _f:
        _f.write(str(_server.port))
    os.replace(_path + ".tmp", _path)
_t0 = time.monotonic()
while not os.path.exists(_path):
    if time.monotonic() - _t0 > %(timeout)d:
        raise TimeoutError("no coordinator port published")
    time.sleep(0.05)
with open(_path) as _f:
    coord = "127.0.0.1:" + _f.read()
""" % {"timeout": TIMEOUT_S}

# each child's last lines: every process of the group is done with it
_FAREWELL = r"""
_dist.barrier()
_dist.destroy_process_group()
"""

# what a process that failed on the network, not on its work, prints
_NETWORK_ERRORS = ("Address already in use", "Connection reset",
                   "Connection refused", "Connection closed", "Broken pipe",
                   "DistNetworkError", "DistStoreError", "IoException",
                   "connectFullMesh", "Socket Timeout")

_CHILD_ENSEMBLE = _RENDEZVOUS + r"""
pid, nproc, nruns, inp, scratch = (int(sys.argv[2]), int(sys.argv[3]),
    int(sys.argv[4]), sys.argv[5], sys.argv[6])
from kalign_tpu_torch.parallel.distributed import init_distributed, \
    my_ensemble_runs, process_count, process_index
init_distributed(coordinator_address=coord, num_processes=nproc,
                 process_id=pid)
assert (process_count(), process_index()) == (nproc, pid)
runs = my_ensemble_runs(nruns)
assert runs == [k for k in range(nruns) if k % nproc == pid], runs
from kalign_tpu_torch.core import io as kio
from kalign_tpu_torch.ensemble import ensemble_worker
msa = kio.read_inputs([inp])
msa.quiet = True
assert ensemble_worker(msa, pid, nproc, scratch, n_runs=nruns, realign=1,
                       consistency_anchors=5, device="cpu") == runs
print("child", pid, "done", runs)
""" + _FAREWELL

_CHILD_MESH = _RENDEZVOUS + r"""
import numpy as np
pid, nproc, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
from kalign_tpu_torch.parallel.distributed import init_distributed
init_distributed(coordinator_address=coord, num_processes=nproc,
                 process_id=pid)
sys.path.insert(0, os.path.join(sys.argv[5], "tests"))
from test_torch_distributed import mesh_case
from kalign_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh(devices=["cpu"] * (8 // nproc))
assert mesh.size == 8 and mesh.spans_processes
assert mesh.local == list(range(pid * (8 // nproc), (pid + 1) * (8 // nproc)))
dm, steps, scores = mesh_case(mesh)
if pid == 0:
    np.savez(out, dm=dm, scores=scores,
             **{f"steps{i}": s for i, s in enumerate(steps)})
print("child", pid, "ok")
""" + _FAREWELL

_CHILD_ALIGN = _RENDEZVOUS + r"""
import numpy as np
import pytest
pid, nproc, k, out = (int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                      sys.argv[5])
from kalign_tpu_torch.parallel.distributed import init_distributed
init_distributed(coordinator_address=coord, num_processes=nproc,
                 process_id=pid)
sys.path.insert(0, os.path.join(sys.argv[6], "tests"))
from test_torch_distributed import DATA, _wide_bucket
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.parallel import mesh as TM
mesh = TM.make_mesh(devices=["cpu"] * (4 // nproc))
assert mesh.size == 4 and mesh.processes == nproc
eng = TE.get_engine("gpu-mesh", mesh=mesh)
m = tio.read_inputs([os.path.join(DATA, "BB11001.tfa")])
m.quiet = True
m = TE.align_msa(m, consistency_anchors=k, engine=eng)
st = m.engine_stats
assert st["engine"] == "gpu-mesh" and st["processes"] == nproc, st
assert st["local_shards"] == mesh.local and st["long_merges"] == 0, st
# one gather for the distances, one for the tree-and-maps check, one a
# sharded bucket; a fetch on each local shard that got problems
sharded = [b for b in st["batches"] if "shards" in b]
assert st["gathers"]["calls"] == 2 + len(sharded), st
assert st["fetches"] == sum(
    sum(1 for j in mesh.local if b["shards"][j]) for b in sharded), st
with open(out + f".{pid}", "w") as fh:
    fh.write(tio.format_alignment(m, "fasta"))
# the column-sharded DP and the engine's route to it stay in one process
with pytest.raises(ValueError, match="one process"):
    TM.sharded_long_gotoh(mesh, np.zeros((4, 4), np.float32),
                          np.zeros((3, 5), np.float32),
                          np.zeros((3, 5), np.float32), 4, 4)
with pytest.raises(ValueError, match="7424"):
    eng.dispatch_bucket(*_wide_bucket())
print("child", pid, "aligned")
""" + _FAREWELL


def _wide_bucket(L1p=128, L2p=7424):
    """One merge too wide for the register row kernel: it takes the
    column-sharded route on a mesh of more than one shard."""
    return (np.zeros((1, L1p, 23), np.float32),
            np.zeros((1, L2p, 23), np.float32),
            np.zeros((1, 3, L2p + 1), np.float32),
            np.zeros((1, 3, L1p + 1), np.float32),
            np.array([L1p], np.int32), np.array([L2p - 100], np.int32),
            np.array([1e-3], np.float32))


def mesh_case(mesh):
    """The sharded distances of BB11001 and one sharded merge bucket on
    deterministic data (test_distributed.py:139-190's case)."""
    from kalign_tpu_torch import engine as TE
    from kalign_tpu_torch.core import alphabet as alpha
    m = tio.read_alignment(os.path.join(DATA, "BB11001.tfa"))
    m.quiet = True
    m.essential_input_check()
    m.dealign()
    m.sort_len_name()
    codes = TE._encoded(m, alpha.ALPHA_REDUCED_PROTEIN)
    lens = np.array([len(c) for c in codes], np.int32)
    toks = np.zeros((len(codes), lens.max()), np.uint8)
    for i, c in enumerate(codes):
        toks[i, :len(c)] = c
    dm = TM.sharded_anchor_distances(mesh, toks, lens, list(range(4)))
    rng = np.random.default_rng(0)
    B, L = 8, 128
    lhs = rng.normal(size=(B, L, 23)).astype(np.float32)
    rhs = rng.normal(size=(B, L, 23)).astype(np.float32)
    pens = np.tile(np.array([-7.0, -1.25, -1.0], np.float32)[None, :, None],
                   (B, 1, L + 1))
    la = np.full(B, L - 5, np.int32)
    lb = np.full(B, L - 3, np.int32)
    eps = np.full(B, 1e-3, np.float32)
    steps, scores = TM.sharded_bucket_step(mesh, lhs, rhs, pens, pens, la,
                                           lb, eps)
    return dm, steps, scores


def _run(code, nproc, *args):
    """nproc processes of code joined by one gloo group (the coordinator's
    port published by process 0: _RENDEZVOUS); each must exit 0 within
    TIMEOUT_S.  A group that failed on the network is run once more
    (_NETWORK_ERRORS).  A failure names every process that did not exit 0,
    with its exit code and its whole output."""
    failed = _group(code, nproc, *args)
    if failed and any(e in out for out in failed for e in _NETWORK_ERRORS):
        print("the group failed on the network; once more. Its output:\n"
              + "\n".join(failed))
        failed = _group(code, nproc, *args)
    assert not failed, "\n".join(failed)


def _group(code, nproc, *args):
    """One run of _run's group: the failing processes' reports."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "port")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, rdv, str(pid), str(nproc),
             *map(str, args)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in range(nproc)]
        try:
            outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return [f"--- process {pid}: exit code {p.returncode}\n{o}"
            for pid, (p, o) in enumerate(zip(procs, outs))
            if p.returncode != 0]


@pytest.mark.parametrize("nproc,nruns", [(2, 3), (4, 6)])
def test_processes_split_the_ensemble_and_merge_to_its_bytes(nproc, nruns,
                                                             tmp_path):
    """Each process aligns its my_ensemble_runs share; the OR-merged POAR
    tables give the sequential ensemble's FASTA."""
    inp = os.path.join(DATA, "small.fa")
    scratch = str(tmp_path / "scratch")
    _run(_CHILD_ENSEMBLE, nproc, nruns, inp, scratch)
    msa = tio.read_inputs([inp])
    msa.quiet = True
    got = tio.write_fasta(ensemble_merge(msa, scratch, n_runs=nruns,
                                         consistency_anchors=5,
                                         device="cpu"))
    msa2 = tio.read_inputs([inp])
    msa2.quiet = True
    want = tio.write_fasta(ensemble_align(msa2, n_runs=nruns, realign=1,
                                          consistency_anchors=5,
                                          device="cpu"))
    assert got == want


@pytest.mark.parametrize("nproc", [2, 4])
def test_a_mesh_across_processes_equals_one_process(nproc, tmp_path):
    """nproc processes x 8 / nproc CPU shards form one 8-shard mesh; its
    sharded distances and bucket equal the one-process 8-shard run's."""
    out = str(tmp_path / "child.npz")
    _run(_CHILD_MESH, nproc, out, ROOT)
    got = np.load(out)
    dm, steps, scores = mesh_case(TM.make_mesh(devices=["cpu"] * 8))
    assert np.array_equal(got["dm"], dm)
    assert np.array_equal(got["scores"], scores)
    for i, s in enumerate(steps):
        assert np.array_equal(got[f"steps{i}"], s)


def test_one_process_needs_no_group():
    """init_distributed is a no-op in one process; the run partition and
    the POAR merge are kalign_tpu's."""
    from kalign_tpu_torch import poar
    D.init_distributed()
    D.init_distributed("127.0.0.1:1", num_processes=1, process_id=0)
    assert (D.process_index(), D.process_count()) == (0, 1)
    assert D.my_ensemble_runs(5) == [0, 1, 2, 3, 4]
    assert D.my_ensemble_runs(7, process_id=1, num_processes=3) == [1, 4]
    assert D.merge_poar_tables is poar.merge_poar_tables
    with pytest.raises(ValueError):
        D.init_distributed(num_processes=2)


def _one_process_bytes(k):
    """BB11001 on the port's gpu-mesh over 4 CPU shards in one process,
    held against kalign_tpu's tpu-mesh (conftest's 8 virtual CPU
    devices; the shard count moves no byte,
    test_torch_mesh.py::test_shard_count_gives_the_same_bytes)."""
    from kalign_tpu import engine as JE
    from kalign_tpu.core import io as jio
    from kalign_tpu_torch import engine as TE
    path = os.path.join(DATA, "BB11001.tfa")
    m = tio.read_inputs([path])
    m.quiet = True
    eng = TE.get_engine("gpu-mesh", mesh=TM.make_mesh(devices=["cpu"] * 4))
    fasta = tio.format_alignment(TE.align_msa(m, consistency_anchors=k,
                                              engine=eng), "fasta")
    jm = jio.read_inputs([path])
    jm.quiet = True
    assert fasta == jio.write_fasta(JE.align_msa(
        jm, consistency_anchors=k, engine="tpu-mesh"))
    return fasta


@pytest.mark.parametrize("k", [0, 5], ids=["fast", "default"])
@pytest.mark.parametrize("nproc", [2, 4])
def test_gpu_mesh_across_processes_aligns_the_one_process_bytes(nproc, k,
                                                                tmp_path):
    """nproc processes x 4 / nproc CPU shards form one 4-shard mesh; the
    engine gpu-mesh aligns BB11001 on it (fast mode, or default mode with
    K = 5) and every process writes the one-process 4-shard mesh's FASTA,
    which is kalign_tpu's tpu-mesh's."""
    out = str(tmp_path / "child.afa")
    _run(_CHILD_ALIGN, nproc, k, out, ROOT)
    want = _one_process_bytes(k)
    for pid in range(nproc):
        with open(f"{out}.{pid}") as fh:
            assert fh.read() == want, f"process {pid}"


def test_the_engine_and_the_column_sharded_dp_take_one_process():
    """The column-sharded DP takes a mesh within one process; the engine
    on a mesh that spans processes runs on this process's first shard
    (its tree and maps there), and raises where it owns none."""
    from kalign_tpu_torch.gpu.engine import GpuEngine
    mesh = TM.make_mesh(devices=["cpu"] * 2)
    mesh.ranks = np.array([[0, 1]])
    assert mesh.spans_processes
    with pytest.raises(ValueError, match="one process"):
        TM.sharded_long_gotoh(mesh, np.zeros((4, 4), np.float32),
                              np.zeros((3, 5), np.float32),
                              np.zeros((3, 5), np.float32), 4, 4)
    # process 1 of [cuda:0 (process 0), cpu (process 1)]: no stream is
    # made for another process's card, and the engine takes the cpu shard
    import torch
    devs = np.array([torch.device("cuda", 0), torch.device("cpu")],
                    dtype=object).reshape(1, 2)
    mine = TM.Mesh(devs, np.array([[0, 1]]), rank=1)
    assert mine.local == [1] and mine.shards[0].stream is None
    eng = GpuEngine(mesh=mine)
    assert eng.device == torch.device("cpu")
    assert (eng.stats["processes"], eng.stats["local_shards"]) == (2, [1])
    with pytest.raises(ValueError, match="first local shard"):
        GpuEngine("cuda:0", mesh=mine)
    with pytest.raises(ValueError, match="owns no shard"):
        GpuEngine(mesh=TM.Mesh(devs, np.array([[0, 1]]), rank=2))


def test_the_column_sharded_route_raises_across_processes():
    """A bucket that would take the column-sharded route on a mesh that
    spans processes raises before anything is queued, naming the width,
    as kalign_tpu's sharded_long_gotoh cannot fetch its decisions across
    processes (parallel/mesh.py:487)."""
    from kalign_tpu_torch.gpu.engine import GpuEngine
    mesh = TM.make_mesh(devices=["cpu"] * 2)
    mesh.ranks = np.array([[0, 1]])
    eng = GpuEngine(mesh=mesh)
    assert not eng.row_feasible(1, 7424)
    with pytest.raises(ValueError, match="128 x 7424"):
        eng.dispatch_bucket(*_wide_bucket())
    assert eng.stats["long_merges"] == 0 and not eng.stats["batches"]
