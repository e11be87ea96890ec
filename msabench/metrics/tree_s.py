"""tree_s (s, program span): msa.phase_times["tree"] per alignment, the
guide tree (GpuEngine.build_tree: the native tree, or gpu/kmeans.py from
2,048 sequences). In a traced run the layer's call is the host range
layer.tree, which names the idle gaps under it."""

from msabench import readers

LAYER = "tree"
RANGE = "kalign_tpu_torch.gpu.engine:GpuEngine.build_tree"


def read(run):
    return readers.phase_mean(run, "tree")
