"""kalign_tpu_torch — the PyTorch/CUDA port of kalign_tpu.

Progressive multiple sequence alignment (Kalign 3 semantics) with its
hot path on an NVIDIA Hopper GPU: anchor distances through a
hand-written bit-parallel (Myers) kernel, the native guide-tree builder,
and level-batched Gotoh merges through hand-written row and
problem-per-lane kernels with the traceback walked on the card.

It runs the default, ``--fast`` and ``--precise`` modes (an ensemble of
runs with POAR selection or consensus, each run realigned once), with
refinement, realignment, post-realignment of an existing alignment
(``post_realign``) and Stockholm output with confidences.  It imports
nothing of JAX or of kalign_tpu: kalign_tpu stays the reference its
tests compare against.
"""

from kalign_tpu_torch.version import __version__
from kalign_tpu_torch.api import align, align_msa, post_realign

__all__ = ["__version__", "align", "align_msa", "post_realign"]
