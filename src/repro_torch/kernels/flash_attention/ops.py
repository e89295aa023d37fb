"""Public wrappers of attention: the flash kernel (prefill) and the decode path.

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors
(counted in this module's ``launches``, and by instance in
``launches_by_design``) and runs its plain version on CPU tensors. The
instance is chosen by :func:`design` from the dtype and head dim alone.
``decode_attention`` is the one-new-token path: at q_len = 1 the work
streams the KV cache once and a blocked kernel buys nothing, so it is
plain tensor ops here, as it is plain einsums in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    DTYPES,
    MAX_HEAD_DIM,
    WGMMA_HEAD_DIMS,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# Launches of the CUDA kernel since import (or since a caller reset them):
# +1 per launch, never for the plain version on the CPU; and the same
# launches by instance.
launches = 0
launches_by_design = {"wgmma": 0, "simt": 0}


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel instance for q, k, v of ``dtype`` at ``head_dim``:
    ``"wgmma"`` (tensor cores, TMA) for bfloat16 at D = 64, 80, 128 or
    192, ``"simt"`` (float32 FMAs) for everything else. float32 stays off
    the tensor cores, where it would be TF32."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS else "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """(B, Hq, T, D) x (B, Hkv, S, D)^2 -> (B, Hq, T, D), in q's type.

    Causal (queries suffix-aligned to the keys), GQA by ``h // (Hq //
    Hkv)``; a query row that sees no key gives 0. CPU tensors run the plain
    version; CUDA tensors (contiguous, float32 or bfloat16, one type, D <=
    256; 16-byte aligned for the wgmma instance) launch the kernel of
    :func:`design` or raise. ``block_q``/``block_k`` are accepted
    for the reference's signature: the kernel tiles by its own sizes, which
    change the result only by float rounding.
    """
    b, hq, t, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention needs q (B, Hq, T, D) and k, v (B, Hkv, S, D), got"
            f" {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if hq % k.shape[1] != 0:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, Hkv={k.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            "flash_attention needs q, k, v on one CUDA device (or the CPU), got"
            f" {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash_attention needs float32 or bfloat16 q, k, v of one type, got"
            f" {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if not 1 <= d <= MAX_HEAD_DIM or b > 65535 or hq > 65535:
        raise ValueError(
            f"flash_attention takes head dims 1..{MAX_HEAD_DIM} and at most 65535"
            f" batches and heads, got D={d}, B={b}, Hq={hq}")
    kind = design(q.dtype, d)
    if kind == "wgmma" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention's wgmma instance needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if k.shape[2] == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        flash_attention_cuda(q, k, v, out, causal, sm_scale, kind)
    global launches
    launches += 1
    launches_by_design[kind] += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len, *, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-step attention against a (B, Hkv, S, D) cache; q is (B, Hq, 1, D).

    ``cache_len`` may be a scalar or a (B,) vector of valid cache lengths.
    float32 math, out in q's type (the reference's ``decode_attention``).
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, group, d).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * sm_scale
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    valid = torch.arange(s, device=q.device)[None, :] < lens[:, None]
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)
