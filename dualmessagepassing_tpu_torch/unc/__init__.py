"""UNC, unsupervised node classification on heterogeneous graphs
(dualmessagepassing_tpu/unc/): the data and its samplers, the backbones
and the training model, the driver. The names below are exported as the
JAX package's unc/__init__.py exports them.

train_unc is read from unc/driver.py at its first use: the driver
imports parallel/ep_unc.py and parallel/halo_unc.py, which import
unc/model.py, so importing the driver here would leave either of them
half-imported when a program imports it first."""

from .data import (WholeGraph, load_label, load_supervised,
                   load_unsupervised, negative_sampling,
                   sample_subgraph_by_neighbors,
                   sample_subgraph_by_randomwalks, save_embeddings)
from .model import UNCDMPNN, DualGraphConv, UNCTrainModel

__all__ = ["DualGraphConv", "UNCDMPNN", "UNCTrainModel", "WholeGraph",
           "load_label", "load_supervised", "load_unsupervised",
           "negative_sampling", "sample_subgraph_by_neighbors",
           "sample_subgraph_by_randomwalks", "save_embeddings", "train_unc"]


def __getattr__(name):
    if name == "train_unc":
        from .driver import train_unc
        return train_unc
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
