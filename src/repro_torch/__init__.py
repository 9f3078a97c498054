"""PyTorch/CUDA port of the certified-precision serving stack.

A second package beside the JAX reference ``repro``; it imports torch and
numpy, never jax or anything of ``repro``.
"""
