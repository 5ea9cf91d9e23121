"""geoestimation_tpu_torch: the PyTorch/CUDA port of geoestimation_tpu.

A package of its own beside the JAX one: it imports torch, never jax, and
nothing of geoestimation_tpu. Its entry points run on CUDA unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"
