"""dcr_tpu_torch: the PyTorch/CUDA port of dcr_tpu for NVIDIA Hopper GPUs.

A package beside the JAX one, with the same module names. It imports torch
and never jax, flax or anything of dcr_tpu. Its kernels are written by hand
for sm_90a under ``csrc/``, its JPEG codec in host C++ under ``native/``;
both are built at first use (``ops/build.py``).
"""
