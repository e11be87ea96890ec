"""msabench: the benchmark of kalign_tpu_torch on NVIDIA GPUs.

    python3 -m msabench.run --workload NAME --seed N --seconds S --trace 0|1

BENCHMARK.json at the root of the checkout names the cells (a
configuration under a traffic mix); this package finds every piece of a
cell by its name: ``configs/<config>.json`` (the family's generator
parameters), ``traffic/<mix>.json`` (mode, engine, refinement, families
made per run) and ``metrics/<metric>.py`` (one reader per metric).  A
cell, a configuration, a mix or a metric is added by adding such a file
and an entry in BENCHMARK.json.  ``reference/`` judges the alignments
against the families' true homology and imports nothing of the program.
"""
