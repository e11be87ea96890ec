"""consistency_s (s, program span): msa.phase_times["consistency"] per
alignment, the consistency maps (gpu/consistency.py,
GpuEngine.dp_leaf_batch). In a traced run the layer's call is the host
range layer.consistency, which names the idle gaps under it."""

from msabench import readers

LAYER = "consistency"
RANGE = "kalign_tpu_torch.gpu.consistency:ConsistencyTable.build"


def read(run):
    return readers.phase_mean(run, "consistency")
