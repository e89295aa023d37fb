"""Kernel 1 (csrc/histogram.cu), phase A's statistics: the least time of
its work (every pair's key and validity read once, the (m, n) histogram
written once) over the device time of its kernels, in %."""
from os4m_bench.readers import kernel_roofline, stats_work

KERNELS = ("histogram_kernel",)


def read(run):
    return kernel_roofline(run, stats_work, *KERNELS)
