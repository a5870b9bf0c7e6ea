"""PyTorch/CUDA port of dualmessagepassing_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here
mirrors the module path of its JAX counterpart and is tested equal to it
on the CPU (tests/test_torch_*.py). This package imports torch, numpy
and the standard library only — never jax, flax, optax, orbax, sklearn
or dualmessagepassing_tpu — so it runs on a machine that has none of
them.

Slices 1 and 2 cover the UNC DMPNN main path on one GPU: host sampling
(unc/data.py, native.py), the model with its loss (unc/model.py),
training and the embedding export (unc/driver.py, train/checkpoint.py,
cli/unc_train.py). Every TPU kernel of the JAX package is a CUDA C++
kernel built with nvcc at first use: the windowed segment-sum and
row-broadcast (csrc/segment_kernels.cu, ops/segment_kernel.py), each
the other's backward in training, and the two experimental scatter
kernels (csrc/scatter_kernels.cu, ops/scatter_kernels.py) that the
kernel bench (bench/kernel_bench.py) runs.
"""
