"""The run's own imports: nothing of JAX, of kalign_tpu or of its old
benchmark may be loaded in the process that prints a result.  Names are
compared whole at the top level (the part before the first dot), so
kalign_tpu_torch is not kalign_tpu."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kalign_tpu", "benchmarks",
                       "bench"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
