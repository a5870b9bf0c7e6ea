"""k1_roofline.unc_train: K1, the sorted segment-sum of
csrc/segment_kernels.cu: the bytes the step's K1 work needs (counts/,
forward and backward) at 3.35 TB/s, as a share of the device time of
the kernels below."""

from perfbench.core.readers import roofline

KERNELS = ("segment_sum_kernel<", "segment_sum_rows_kernel<")


def read(record):
    return roofline(record, "K1", KERNELS)
