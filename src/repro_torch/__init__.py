"""OS4M on PyTorch and CUDA: the port of the ``repro`` engine to one GPU.

The engine's slots are a leading ``(m,)`` axis of every tensor on one
device (the stacked-slots form of the reference's ``vmap`` backend), the
host planners are numpy, and the kernels are CUDA C++ for Hopper
(``csrc/``), built at first use. On CPU tensors every
kernel wrapper runs its plain PyTorch version instead, which is how the
tests hold the port against the JAX reference. See ``core.mapreduce``.
"""
