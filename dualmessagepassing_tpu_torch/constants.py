"""Numeric constants read by the port (dualmessagepassing_tpu/constants.py)."""

# Negative slope of the reference's LeakyReLU (constants.py:LEAKY_RELU_A).
LEAKY_RELU_A = 1.0 / 5.5
