"""Multi-GPU sharding (mesh.py) and multi-process helpers
(distributed.py): the port of kalign_tpu/parallel/."""
