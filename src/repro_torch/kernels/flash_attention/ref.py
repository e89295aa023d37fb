"""Plain PyTorch versions of attention: the reference's oracle and the
flash kernel's plain version."""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """The reference's oracle (``repro.kernels.flash_attention.ref``):
    materialised float32 softmax, queries suffix-aligned, kv heads repeated
    for GQA. A query row that sees no key gives NaN, as there."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(diagonal=s - t)
        logits = torch.where(mask, logits, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """The flash kernel's function, with its scores materialised.

    q (B, Hq, T, D), k and v (B, Hkv, S, D); query head h reads kv head
    ``h // (Hq // Hkv)``; query row i sits at key position ``S - T + i``.
    Scores ``(q . k) * scale`` in float32; the probabilities are cast to
    v's type before the product with v (the reference kernel's
    ``p.astype(v.dtype)``), the normaliser is their float32 sum. A row
    that sees no key gives 0, as the reference kernel's ``l == 0 -> 0``.
    Out in q's type.
    """
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, g, t, d).float()
    sc = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * sm_scale
    if causal:
        kv_idx = torch.arange(s, device=q.device)
        q_pos = (s - t) + torch.arange(t, device=q.device)
        mask = kv_idx[None, :] <= q_pos[:, None]
        sc = torch.where(mask, sc, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)         # rows that see no key
    p = torch.exp(sc - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgts,bhsd->bhgtd", p.to(v.dtype).float(), v.float())
    norm = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return (o * norm[..., None]).to(q.dtype).reshape(b, hq, t, d)
