"""k3_roofline.scm_train: K3, the unsorted segment-sum of
csrc/scatter_kernels.cu: the bytes the step's K3 work needs (counts/) at
3.35 TB/s, as a share of the device time of the kernel below and of the
memset its launcher issues before it (the output's zeroing)."""

from perfbench.core.readers import roofline

KERNELS = ("segment_sum_unsorted_kernel<",)


def read(record):
    return roofline(record, "K3", KERNELS, memset_before=True)
