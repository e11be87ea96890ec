"""progressive_s (s, program span): msa.phase_times["progressive"] per
alignment, the progressive pass (gpu/resident.py). In a traced run the
layer's call is the host range layer.progressive, which names the idle
gaps under it."""

from msabench import readers

LAYER = "progressive"
RANGE = "kalign_tpu_torch.gpu.engine:GpuEngine.align"


def read(run):
    return readers.phase_mean(run, "progressive")
