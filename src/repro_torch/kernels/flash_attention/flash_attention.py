"""ctypes binding of ``csrc/flash_attention.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# Element types the kernel takes, by its dtype code.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# Head dims of the wgmma instance (bfloat16 only): the full-width configs'
# 64 and 128, zamba2's shared block's 80 and MLA's 192.
WGMMA_HEAD_DIMS = (64, 80, 128, 192)

# b, hq, hkv, t, s, d, causal, scale, stream: the tail of both C entries.
_SHAPE_ARGS = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _entries():
    lib = _build.load("flash_attention")
    simt = lib.flash_attention_fwd
    simt.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + _SHAPE_ARGS
    simt.restype = ctypes.c_int
    wgmma = lib.flash_attention_fwd_wgmma
    wgmma.argtypes = [ctypes.c_void_p] * 4 + _SHAPE_ARGS
    wgmma.restype = ctypes.c_int
    return {"simt": simt, "wgmma": wgmma}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, causal: bool, sm_scale: float,
                         design: str) -> None:
    """Launch the kernel's ``design`` instance (``"wgmma"`` or ``"simt"``):
    fills ``out`` (q's shape and type).

    Shapes, types, device, contiguity and the instance are the caller's to
    check and choose (``ops.flash_attention``). Raises if the launch is
    refused.
    """
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (b, hq, hkv, t, s, d, int(causal), float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if design == "wgmma":
        rc = _entries()["wgmma"](*ptrs, *shape)
    else:
        rc = _entries()["simt"](*ptrs, DTYPES[q.dtype], *shape)
    if rc != 0:
        raise RuntimeError(f"flash_attention {design} kernel launch failed: cudaError {rc}")
