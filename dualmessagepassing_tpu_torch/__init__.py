"""PyTorch/CUDA port of dualmessagepassing_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here
mirrors the module path of its JAX counterpart and is tested equal to it
on the CPU (tests/test_torch_*.py). This package imports torch, numpy
and the standard library only — never jax, flax, optax, orbax, sklearn
or dualmessagepassing_tpu — so it runs on a machine that has none of
them.

Slice 1 covers the UNC DMPNN embedding-export serving path: host
sampling (unc/data.py, native.py), the model forward (unc/model.py) and
the export loop (unc/driver.py). Its two TPU kernels, the windowed
segment-sum and the windowed row-broadcast, are CUDA C++ kernels
(csrc/segment_kernels.cu, ops/segment_kernel.py), built with nvcc at
first use.
"""
