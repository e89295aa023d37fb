"""Hand-written CUDA kernels of the port, one subpackage each.

Each subpackage has:
  <name>.py — the ctypes binding of ``csrc/<name>.cu`` (built by ``_build``)
  ops.py    — the public wrapper: the kernel for CUDA tensors, the plain
              version for CPU tensors, and a ``launches`` counter
  ref.py    — the plain PyTorch version of the same function

  histogram            — phase A's per-slot K^(i) (paper §4.1)
  fused_shuffle_reduce — phase B's gather + sorted segment-sum (§4.4)
"""
