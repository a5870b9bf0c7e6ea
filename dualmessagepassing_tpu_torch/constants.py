"""Numeric constants read by the port (dualmessagepassing_tpu/constants.py)."""

# the reference's INF: an attention's masked keys score -_INF
_INF = 1e30
# Negative slope of the reference's LeakyReLU (constants.py:LEAKY_RELU_A).
LEAKY_RELU_A = 1.0 / 5.5

EPS = 1e-8
PI = 3.141592653589793

# scalar-schedule defaults (reference constants.py)
INIT_STEPS = 600
SCHEDULE_STEPS = 10000
NUM_CYCLES = 2
MIN_PERCENT = 1e-3
