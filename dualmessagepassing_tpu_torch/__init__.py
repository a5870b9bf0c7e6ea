"""PyTorch/CUDA port of dualmessagepassing_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here
mirrors the module path of its JAX counterpart and is tested equal to it
on the CPU (tests/test_torch_*.py). This package imports torch, numpy
and the standard library only — never jax, flax, optax, orbax, sklearn
or dualmessagepassing_tpu — so it runs on a machine that has none of
them.

The port covers UNC on one GPU: host sampling (unc/data.py,
native.py), every backbone (DMPNN, CompGCN, R-GCN, R-GIN) with learned,
attributed or multi-hot inputs and both heads (unc/model.py), training,
supervised training and the embedding export (unc/driver.py,
train/checkpoint.py, cli/unc_train.py), and the downstream evaluation
without scikit-learn (unc/evaluate.py, unc/linear_svc.py over LIBLINEAR's
solvers in csrc/linear_svc.cpp, cli/unc_evaluate.py; unc/transform.py,
cli/unc_transform.py). It covers SCM subgraph counting and matching:
the nine representation networks of the JAX CLI (DMPNN, CompGCN, R-GCN,
R-GIN, LRP, DMPLRP, CNN, RNN, TXL; models/) over the pooling predict
nets, training and evaluation (train/), the command lines
(cli/scm_train.py, cli/scm_evaluate.py) and the learning gates
(gates/). Every TPU kernel of the JAX package is a CUDA C++
kernel built with nvcc at first use: the windowed segment-sum and
row-broadcast (csrc/segment_kernels.cu, ops/segment_kernel.py), each
the other's backward in training, and the two experimental scatter
kernels (csrc/scatter_kernels.cu, ops/scatter_kernels.py) that the
kernel bench (bench/kernel_bench.py) runs.
"""
