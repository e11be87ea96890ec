"""sp_miss: 1 - SP recall of the rows against the family's true
homology over sequence pairs drawn from the seed (reference/homology.py);
1 where a row is wrong.  Judges the product of every layer: the rows."""

from msabench.reference import homology


def value(fam, rows, records, ctx):
    return homology.judge(rows, fam[0], fam[1], ctx["seed"])["sp_miss"]
