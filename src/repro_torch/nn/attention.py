"""Attention layers of the port: GQA with RoPE and qkv bias, prefill and
per-lane decode against a KV cache.

Three execution paths for train/prefill, selected by ``impl`` as in the
reference (``repro.nn.attention``), so that configurations carry across:

* ``blocked`` — online softmax over kv blocks in plain tensor ops (the
  reference's ``_blocked_fwd_impl``; forward only here);
* ``pallas``  — the hand-written kernel (``kernels/flash_attention``): on
  CUDA tensors it launches ``csrc/flash_attention.cu``, on CPU tensors it
  runs the kernel's plain version;
* ``naive``   — materialised scores (the reference's oracle).

Decode (q_len = 1) always takes the einsum path (``decode_attention``).
The KV cache is written in place: a decode step writes one row per lane
into the cache it was given, and a prefill writes its block at 0 (the
model's ``forward`` hands prefill a copy, so the caller's cache stays as
it was, as the reference's functional update leaves it).

MLA (DeepSeek-V2) and the sequence- or head-sharded attention over a mesh
are not ported yet (ROADMAP item 12): a configuration with ``mla`` set is
refused when its model is built (``models.model.check_supported``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.nn import layers as L

__all__ = ["Attention", "blocked_attention"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _block_mask(k0: int, block_k: int, s: int, q_pos: torch.Tensor,
                causal: bool) -> torch.Tensor:
    kv_idx = k0 + torch.arange(block_k, device=q_pos.device)
    mask = (kv_idx[None, :] < s).expand(q_pos.shape[0], block_k)
    if causal:
        mask = mask & (kv_idx[None, :] <= q_pos[:, None])
    return mask  # (t, block_k)


def _blocked_fwd_impl(q, k, v, q_pos, causal: bool, block_k: int, scale: float):
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    pad = (-s) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nk = (s + pad) // block_k
    qg = q.reshape(b, hkv, g, t, d).float()
    m = torch.full((b, hkv, g, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, t, d), dtype=torch.float32, device=q.device)
    for i in range(nk):
        k0 = i * block_k
        kblk = k[:, :, k0:k0 + block_k].float()
        vblk = v[:, :, k0:k0 + block_k]
        sc = torch.einsum("bhgtd,bhsd->bhgts", qg, kblk) * scale
        mask = _block_mask(k0, block_k, s, q_pos, causal)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgts,bhsd->bhgtd", p.to(v.dtype).float(), vblk.float())
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(b, hq, t, d)


def blocked_attention(q, k, v, *, causal: bool, block_k: int = 1024,
                      sm_scale: Optional[float] = None, q_pos=None) -> torch.Tensor:
    """(B,Hq,T,D) x (B,Hkv,S,D)^2 -> (B,Hq,T,D): online softmax over kv blocks.

    ``q_pos`` gives the absolute kv-axis position of each query row
    (default: suffix alignment). Forward only: the reference's flash-style
    backward is part of training (ROADMAP item 12).
    """
    d = q.shape[-1]
    t, s = q.shape[2], k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    block_k = min(block_k, s)
    if q_pos is None:
        q_pos = (s - t) + torch.arange(t, device=q.device)
    return _blocked_fwd_impl(q, k, v, q_pos, causal, block_k, scale)


def _run_attention(q, k, v, *, causal: bool, impl: str, block_q: int,
                   block_k: int) -> torch.Tensor:
    if q.shape[2] == 1:   # decode: one pass over the cache
        return fa_ops.decode_attention(q, k, v, k.shape[2])
    if impl == "pallas":
        return fa_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                      causal=causal, block_q=block_q, block_k=block_k)
    if impl == "blocked":
        return blocked_attention(q, k, v, causal=causal, block_k=block_k)
    return attention_ref(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The reference's ``init_attention`` / ``attention``: q, k, v, o linears."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                 bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.q = L.Linear(d_model, n_heads * head_dim, bias=bias, dtype=dtype, device=device)
        self.k = L.Linear(d_model, n_kv * head_dim, bias=bias, dtype=dtype, device=device)
        self.v = L.Linear(d_model, n_kv * head_dim, bias=bias, dtype=dtype, device=device)
        self.o = L.Linear(n_heads * head_dim, d_model, dtype=dtype, device=device)

    def reset(self, gen: torch.Generator) -> None:
        for lin in (self.q, self.k, self.v, self.o):
            lin.reset(gen)

    def forward(self, x: torch.Tensor, *, positions=None, rope_kind: str = "rope",
                rope_theta: float = 10000.0, causal: bool = True,
                cache: Optional[dict] = None, cache_pos=None, impl: str = "blocked",
                block_q: int = 512, block_k: int = 1024):
        """Returns ``(out (B, T, d), new_cache or None)``.

        ``cache``: ``{"k", "v"}`` of (B, S, n_kv, hd), written in place (see
        the module docstring); ``cache_pos``: the decode write position, a
        scalar or a (B,) vector (continuous batching).
        """
        b, t, _ = x.shape
        h, hkv, hd = self.n_heads, self.n_kv, self.head_dim
        q = self.q(x).reshape(b, t, h, hd)
        k = self.k(x).reshape(b, t, hkv, hd)
        v = self.v(x).reshape(b, t, hkv, hd)
        if positions is not None and rope_kind != "none":
            if rope_kind != "rope":
                raise NotImplementedError(
                    f"rope_kind={rope_kind!r} (M-RoPE, the vlm family) is not ported"
                    " yet (ROADMAP item 12)")
            q = L.apply_rope(q, positions, rope_theta)
            k = L.apply_rope(k, positions, rope_theta)
        new_cache = None
        if cache is not None:
            k_cache, v_cache = cache["k"], cache["v"]
            if t == 1:   # decode: write one step at cache_pos
                pos = torch.as_tensor(cache_pos, device=x.device)
                if pos.dim() == 0:
                    k_cache[:, int(pos)] = k[:, 0]
                    v_cache[:, int(pos)] = v[:, 0]
                else:    # per-lane positions (continuous batching)
                    rows = torch.arange(b, device=x.device)
                    k_cache[rows, pos.long()] = k[:, 0].to(k_cache.dtype)
                    v_cache[rows, pos.long()] = v[:, 0].to(v_cache.dtype)
                k, v = k_cache, v_cache
            else:        # prefill: write the whole block at 0
                k_cache[:, :t] = k
                v_cache[:, :t] = v
            new_cache = {"k": k_cache, "v": v_cache}

        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if cache is not None and t == 1:
            # Decode against the cache with a validity length of cache_pos + 1.
            lens = torch.as_tensor(cache_pos, device=x.device) + 1
            out = fa_ops.decode_attention(qh, kh, vh, lens)
        else:
            out = _run_attention(qh, kh, vh, causal=causal, impl=impl,
                                 block_q=block_q, block_k=block_k)
        out = out.transpose(1, 2).reshape(b, t, h * hd)
        return self.o(out), new_cache

