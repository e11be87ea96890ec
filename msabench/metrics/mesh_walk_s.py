"""mesh_walk_s (s, program span): msa.phase_times["mesh.walk"] per
alignment, the column-sharded DPs' walks: from the first band's walk to
the steps on the host, each band walked on its own card and handing its
last cell to the band on its left (parallel/mesh.py::walk_bands), after
the DP's forward has finished; summed over the alignment.  None where no
alignment ran the route."""

from msabench import readers


def read(run):
    return readers.phase_mean(run, "mesh.walk")
