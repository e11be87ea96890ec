"""kalign_tpu_torch — the PyTorch/CUDA port of kalign_tpu.

Progressive multiple sequence alignment (Kalign 3 semantics) with its
hot path on an NVIDIA Hopper GPU: anchor distances through a
hand-written bit-parallel (Myers) kernel, the native guide-tree builder,
and level-batched Gotoh merges through hand-written row and
problem-per-lane kernels with the traceback walked on the card.

It runs the default, ``--fast`` and ``--precise`` modes (an ensemble of
runs with POAR selection or consensus, each run realigned once), with
refinement, realignment, post-realignment of an existing alignment
(``post_realign``) and Stockholm output with confidences.  Around them:
python-kalign's API (kalign_tpu/__init__.py's exports), the reformatter
(reformat.py), a warm alignment server (serve.py, warmup.py) and device
traces (``--trace``, utils/devtime.py).  It imports nothing of JAX or of
kalign_tpu: kalign_tpu stays the reference its tests compare against.
"""

import importlib

from kalign_tpu_torch.version import __version__

_API = ("align", "align_msa", "align_from_file", "align_file_to_file",
        "compare", "compare_detailed", "compare_with_mask", "post_realign",
        "write_alignment", "read_alignment", "generate_test_sequences",
        "set_num_threads", "get_num_threads")
_MODULES = ("api", "io", "utils")

__all__ = ["__version__", *_API, *_MODULES]


def __getattr__(name):
    """The API loads at its first use, not at import: importing the
    package (a CLI call that only talks to the warm server, for one)
    does not import torch."""
    if name in _API:
        return getattr(importlib.import_module("kalign_tpu_torch.api"), name)
    if name in _MODULES:
        return importlib.import_module(f"kalign_tpu_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
