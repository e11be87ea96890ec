"""score_miss: the largest relative gap, over an alignment's merges on
the column-sharded route, between the score the bands' forward reports
and the score of the path its walk gives, rescored on the host from the
profiles, each step's term added in float32 in path order as the DP adds
them (msabench/long_dps.py::rescored, reference/kalign_dp.py::
step_terms): |score - rescored| / max(|rescored|, 1).  Judges the bands'
forward (csrc/gotoh_mesh.cu, the strips between bands and the match
each band's source makes, parallel/mesh.py::LongQueue): a band that
starts from wrong values at its left edge reports a score no path has,
a match made in a lower precision adds up to another score than its
path has.  An alignment with no merge on the route, or none seen, reads
1."""

from msabench import long_dps

AROUND = long_dps.AROUND


def value(fam, rows, records, ctx):
    got = long_dps.merges(records)
    if not got:
        return 1.0
    worst = 0.0
    for rec, steps, score in got:
        r = long_dps.rescored(rec, steps)
        worst = max(worst, abs(score - r) / max(abs(r), 1.0))
    return worst
