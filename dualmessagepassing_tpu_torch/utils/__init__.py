"""Activations, initialisers, mixed precision, I/O and logging
(dualmessagepassing_tpu/utils/). The names below are exported as the
JAX package's utils/__init__.py exports them."""

from .act import map_activation_str_to_fn, sparsemax, supported_act_funcs
from .init import calculate_gain, get_initializer, scaled

__all__ = ["calculate_gain", "get_initializer", "map_activation_str_to_fn",
           "scaled", "sparsemax", "supported_act_funcs"]
