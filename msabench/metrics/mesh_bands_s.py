"""mesh_bands_s (s, program span): msa.phase_times["mesh.bands"] per
alignment, the host's seconds queueing the column-sharded DPs (merges
and consistency-map DPs whose bands span the mesh's cards): their
operands, the bands' match sources and the band kernel's launches
(parallel/mesh.py::LongQueue.submit, GpuEngine.long_maps), summed over
the alignment.  None where no alignment ran the route."""

from msabench import readers


def read(run):
    return readers.phase_mean(run, "mesh.bands")
