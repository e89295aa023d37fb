"""Kernel 9 (csrc/flash_attention.cu), MLA's prefill attention: the least
time of every prefill's attention in the window (every lane's causal
attention over the prompt, 128 heads, q and k of 192 dims, v and the output
of 128, each read or written once) over the device time of its kernels, in %."""
from os4m_bench.serve_work import attention_roofline

KERNELS = ("flash_fwd",)


def read(run):
    return attention_roofline(run, *KERNELS)
