"""The engine "gpu-mesh" against kalign_tpu's "tpu-mesh" on a divergent
family: BB30014 in default mode (consistency K = 5) autoroutes from both
mesh engines to the bit-exact engine, after anchor distances sharded over
the mesh (kalign_tpu on conftest's 8 virtual CPU devices, the port on 8
CPU shards).  The two must give the same bytes, and those of the golden
file."""

import os

import jax

from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.parallel import mesh as TM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def test_gpu_mesh_equals_tpu_mesh_on_a_divergent_family():
    assert jax.device_count() == 8
    path = os.path.join(DATA, "BB30014.tfa")
    jm = jio.read_inputs([path])
    jm.quiet = True
    jm = JE.align_msa(jm, consistency_anchors=5, engine="tpu-mesh")
    m = tio.read_inputs([path])
    m.quiet = True
    eng = TE.get_engine("gpu-mesh", mesh=TM.make_mesh(devices=["cpu"] * 8))
    m = TE.align_msa(m, consistency_anchors=5, engine=eng)
    assert m.engine_stats["engine"] == "gpu"
    assert m.engine_stats["routed_from"] == "gpu-mesh"
    fasta = tio.format_alignment(m, "fasta")
    assert fasta == jio.write_fasta(jm)
    with open(os.path.join(ROOT, "tests", "golden",
                           "BB30014.default.afa")) as fh:
        assert fasta == fh.read()
