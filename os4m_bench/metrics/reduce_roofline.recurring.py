"""Kernel 2 (csrc/fused_shuffle_reduce.cu), phase B's gather + segment
sum: the least time of its work (every valid pair's values and segment id
read once, each cluster's sums and count written once) over the device
time of its two kernels, in %."""
from os4m_bench.readers import kernel_roofline, reduce_work

KERNELS = ("segment_starts", "reduce_tiles&GatherRows")


def read(run):
    return kernel_roofline(run, reduce_work, *KERNELS)
