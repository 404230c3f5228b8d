"""PyTorch/CUDA port of vn_pointcloudcompletion_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference.  This package imports neither
JAX nor anything of that package; each TPU kernel on its path is a CUDA
kernel written by hand under ``csrc/``, built at first use
(``ops/cuda_lib.py``).  Entry points run on the card unless the caller asks
for the CPU, where every kernel is replaced by its plain PyTorch version.
"""
