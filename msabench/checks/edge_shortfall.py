"""edge_shortfall: the largest shortfall, in score units, of a path at
a band edge, over an alignment's merges on the column-sharded route:
the best score between the path's cells 64 columns either side of the
edge, by Kalign's recurrences in float64 over that window alone, less
the path's own score there (msabench/long_dps.py::shortfalls,
reference/kalign_dp.py::window_best).  Judges what passes between
cards at an edge: the strip a band's forward reads from its left
neighbour, and the cell and state the walk hands to the band on its
left (parallel/mesh.py::walk_bands, csrc/traceback.cu's band form).  A
sound path is the best there up to the float32 DP's rounding; a cell or
state handed wrong, or a band started from wrong values, leaves a
detour there.  An alignment with no merge on the route, or none seen,
reads 1e9."""

from msabench import long_dps

AROUND = long_dps.AROUND


def value(fam, rows, records, ctx):
    got = long_dps.merges(records)
    if not got:
        return 1e9
    return max([0.0] + [s for rec, steps, _ in got
                        for s in long_dps.shortfalls(rec, steps)])
