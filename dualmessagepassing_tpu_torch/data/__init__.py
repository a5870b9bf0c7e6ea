"""SCM data (dualmessagepassing_tpu/data/): the dataset and its
collation, subisomorphism enumeration and weights, synthetic pairs. The
names below are exported as the JAX package's data/__init__.py exports
them."""

from .dataset import GraphAdjDataset
from .subiso import (edge_subiso_weights, enumerate_subisomorphisms,
                     node_subiso_weights)
from .synthetic import generate_dataset, generate_pair

__all__ = ["GraphAdjDataset", "edge_subiso_weights",
           "enumerate_subisomorphisms", "generate_dataset", "generate_pair",
           "node_subiso_weights"]
