"""k2_roofline.unc_train: K2, the sorted row gather of
csrc/segment_kernels.cu: the bytes the step's K2 work needs (counts/,
forward and backward) at 3.35 TB/s, as a share of the device time of
the kernel below."""

from perfbench.core.readers import roofline

KERNELS = ("gather_rows_sorted_kernel<",)


def read(record):
    return roofline(record, "K2", KERNELS)
