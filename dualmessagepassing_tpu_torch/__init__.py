"""PyTorch/CUDA port of dualmessagepassing_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here
mirrors the module path of its JAX counterpart and is tested equal to it
on the CPU (tests/test_torch_*.py). This package imports torch, numpy
and the standard library only — never jax, flax, optax, orbax, sklearn
or dualmessagepassing_tpu — so it runs on a machine that has none of
them. Its entry points run on the card unless the caller asks for the
CPU (device="cpu", --device cpu).

Every module of the JAX package has its counterpart:
  * SCM subgraph counting and matching: the nine representation
    networks (DMPNN, CompGCN, R-GCN, R-GIN, LRP, DMPLRP, CNN, RNN, TXL;
    models/) under every predict net (pooling, attention, memory),
    training and evaluation (train/), the data (data/, graph.py), the
    command lines (cli/scm_train.py, cli/scm_evaluate.py) and the
    learning gates (gates/);
  * UNC node embedding on heterogeneous graphs: host sampling
    (unc/data.py, native.py), the four backbones with every input and
    both heads (unc/model.py), training, supervised training and the
    export (unc/driver.py, cli/unc_train.py), the evaluation without
    scikit-learn (unc/evaluate.py over LIBLINEAR's solvers in
    csrc/linear_svc.cpp, cli/unc_evaluate.py, cli/unc_transform.py);
  * scale-out over torch.distributed (parallel/): data-parallel SCM,
    edge-partitioned and owner-sharded (halo) UNC training, the
    demonstration layer and the halo library with their benches
    (bench/), the dry run (dryrun.py) and the north-star gate;
  * the operations (ops/), with the helpers that no model calls, and
    the public API below; the JAX package's examples as examples/.

The repository's four TPU kernels are CUDA C++ kernels for sm_90a,
built with nvcc at first use (ops/build.py): the windowed segment-sum
K1 and row-broadcast K2, each the other's backward in UNC training
(csrc/segment_kernels.cu, ops/segment_kernel.py); the unsorted
segment-sum K3 (csrc/scatter_kernels.cu, ops/scatter_kernels.py), on
every SCM path, under the demonstration layer and the helpers; and the
CSR segment-sum K4 (K1's kernel), which the kernel bench runs
(bench/kernel_bench.py). A CPU tensor takes each kernel's plain PyTorch
version; a CUDA tensor launches the kernel or raises.

    from dualmessagepassing_tpu_torch import (ModelConfig, batch_graphs,
                                              build_model, single_graph)
"""

__version__ = "0.1.0"

from .graph import FlatGraph, GraphBatch, batch_graphs, single_graph
from .models.basemodel import ModelConfig
from .models.scm_models import build_model

__all__ = [
    "FlatGraph",
    "GraphBatch",
    "ModelConfig",
    "batch_graphs",
    "build_model",
    "single_graph",
]
