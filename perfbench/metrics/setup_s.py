"""setup_s: host seconds from the process's start to the window's: the
imports, the build of the kernels where the checkout has none, the
inputs and weights, and the warm-up steps."""


def read(record):
    return record["setup_s"]
