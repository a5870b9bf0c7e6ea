"""device_ms.scm_train: device time a step, kernels, memsets and copies, from
the traced window's profile."""

from perfbench.core.readers import device_ms


def read(record):
    return device_ms(record)
