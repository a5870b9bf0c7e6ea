"""mfu.unc_train: the whole step's matmul FLOPs (counts/) over the window's
seconds, as a share of the card's float32 matmul peak."""

from perfbench.core.readers import mfu


def read(record):
    return mfu(record)
