"""The SCM models (dualmessagepassing_tpu/models/): the base model, the
DMPNN layer and stack, the registry of representation networks and
build_model. The names below are exported as the JAX package's
models/__init__.py exports them."""

from .basemodel import GraphAdjModelV2, ModelConfig
from .dmpnn import DMPLayer, DMPNNStack
from .scm_models import DMPNN, MODEL_REGISTRY, build_model

__all__ = ["DMPLayer", "DMPNN", "DMPNNStack", "GraphAdjModelV2",
           "MODEL_REGISTRY", "ModelConfig", "build_model"]
