"""rows_wrong (exact, limit 0): rows that are not their input sequence
with gaps put in, a row missing, or a row of another width
(reference/homology.py).  Judges the output rows."""

from msabench.reference import homology


def value(fam, rows, records, ctx):
    return homology.rows_wrong(rows, fam[0])
