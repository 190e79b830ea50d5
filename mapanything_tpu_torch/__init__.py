"""PyTorch/CUDA port of mapanything_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only; never JAX, Flax or
mapanything_tpu. Entry points run on CUDA unless the caller passes
device="cpu".
"""
