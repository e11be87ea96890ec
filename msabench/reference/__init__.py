"""The yardstick's plain reference: NumPy and PyTorch only.

It imports neither JAX nor kalign_tpu nor anything of kalign_tpu_torch,
and takes nothing the program made but the rows it is judging.
"""
