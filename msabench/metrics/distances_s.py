"""distances_s (s, program span): msa.phase_times["distances"] per
alignment, the anchor distances (gpu/distances.py, gpu/bpm.py: the BPM
kernel). In a traced run the layer's call is the host range
layer.distances, which names the idle gaps under it."""

from msabench import readers

LAYER = "distances"
RANGE = "kalign_tpu_torch.gpu.engine:GpuEngine.anchor_distances"


def read(run):
    return readers.phase_mean(run, "distances")
