"""Attention layers of the port: GQA with RoPE or M-RoPE and qkv bias,
cross-attention over given keys and values, and DeepSeek-V2's MLA, with
prefill and per-lane decode against a KV cache.

Three execution paths for train/prefill, selected by ``impl`` as in the
reference (``repro.nn.attention``), so that configurations carry across:

* ``blocked`` — online softmax over kv blocks in plain tensor ops, with
  the reference's flash-style backward (``_BlockedAttention``: the
  forward saves q, k, v, the output and the float32 logsumexp, and the
  backward recomputes each kv block's probabilities); training runs it;
* ``pallas``  — the hand-written kernel (``kernels/flash_attention``): on
  CUDA tensors it launches ``csrc/flash_attention.cu``, on CPU tensors it
  runs the kernel's plain version. Forward only: the kernel has no
  backward (the reference's has no VJP either), so a call whose inputs
  need a gradient raises;
* ``naive``   — materialised scores (the reference's oracle).

Decode (q_len = 1) always takes the einsum path (``decode_attention``);
MLA decodes in the absorbed form, against its compressed cache. The KV
cache is written in place: a decode step writes one row per lane into the
cache it was given, and a prefill writes its block at 0 (the model's
``forward`` hands prefill a copy, so the caller's cache stays as it was,
as the reference's functional update leaves it).

The sequence- or head-sharded attention over a mesh is not ported: the
port runs on one device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import default_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.nn import layers as L

__all__ = ["Attention", "MLA", "blocked_attention"]

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
    lse = m + torch.log(torch.clamp(l, min=1e-30))          # (b, hkv, g, t) f32
    return out.reshape(b, hq, t, d), lse


def _blocked_bwd_impl(q, k, v, q_pos, out, lse, dout, causal: bool, block_k: int,
                      scale: float):
    """The reference's ``_blocked_attention_bwd``: per kv block, the
    probabilities recomputed from ``lse``, ``delta = rowsum(dout * out)``;
    dq, dk and dv accumulate in float32 over the blocks and the GQA group."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    pad = (-s) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nk = (s + pad) // block_k
    qg = q.reshape(b, hkv, g, t, d).float()
    dog = dout.reshape(b, hkv, g, t, d)
    delta = torch.sum(dog.float() * out.reshape(b, hkv, g, t, d).float(), dim=-1)
    dq = torch.zeros((b, hkv, g, t, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, hkv, s + pad, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for i in range(nk):
        k0 = i * block_k
        kblk = k[:, :, k0:k0 + block_k].float()
        vblk = v[:, :, k0:k0 + block_k].float()
        sc = torch.einsum("bhgtd,bhsd->bhgts", qg, kblk) * scale
        mask = _block_mask(k0, block_k, s, q_pos, causal)
        p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
        dv[:, :, k0:k0 + block_k] = torch.einsum(
            "bhgts,bhgtd->bhsd", p.to(dout.dtype).float(), dog.float())
        dp = torch.einsum("bhgtd,bhsd->bhgts", dog.float(), vblk)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhgts,bhsd->bhgtd", ds.to(k.dtype).float(), kblk)
        dk[:, :, k0:k0 + block_k] = torch.einsum(
            "bhgts,bhgtd->bhsd", ds.to(q.dtype).float(), qg)
    return (dq.reshape(b, hq, t, d).to(q.dtype), dk[:, :, :s].to(k.dtype),
            dv[:, :, :s].to(v.dtype))


class _BlockedAttention(torch.autograd.Function):
    """Blocked attention with the flash-style backward: only q, k, v, the
    output and the logsumexp are saved, never a block's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, causal, block_k, scale):
        out, lse = _blocked_fwd_impl(q, k, v, q_pos, causal, block_k, scale)
        ctx.save_for_backward(q, k, v, q_pos, out, lse)
        ctx.causal, ctx.block_k, ctx.scale = causal, block_k, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _blocked_bwd_impl(q, k, v, q_pos, out, lse, dout, ctx.causal,
                                       ctx.block_k, ctx.scale)
        return dq, dk, dv, None, None, None, None


def blocked_attention(q, k, v, *, causal: bool, block_k: int = 1024,
                      sm_scale: Optional[float] = None, q_pos=None) -> torch.Tensor:
    """(B,Hq,T,D) x (B,Hkv,S,D)^2 -> (B,Hq,T,D): online softmax over kv blocks.

    ``q_pos`` gives the absolute kv-axis position of each query row
    (default: suffix alignment). Differentiable in q, k and v through the
    reference's flash-style backward.
    """
    d = q.shape[-1]
    t, s = q.shape[2], k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    block_k = min(block_k, s)
    if q_pos is None:
        q_pos = (s - t) + torch.arange(t, device=q.device)
    return _BlockedAttention.apply(q, k, v, q_pos, causal, block_k, scale)


def _run_attention(q, k, v, *, causal: bool, impl: str, block_q: int,
                   block_k: int) -> torch.Tensor:
    if q.shape[2] == 1:   # decode: one pass over the cache
        return fa_ops.decode_attention(q, k, v, k.shape[2])
    if impl == "pallas":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise RuntimeError(
                "attn_impl='pallas' cannot train: the flash-attention kernel (kernel 9) "
                "is forward only, with no backward kernel (the reference's Pallas kernel "
                "has no VJP either); train with attn_impl='blocked'")
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
        """Uninitialised weights on ``device`` (default: the current CUDA
        device; without one this raises)."""
        super().__init__()
        device = default_device(device, "Attention")
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.q = L.Linear(d_model, n_heads * head_dim, bias=bias, dtype=dtype, device=device)
        self.k = L.Linear(d_model, n_kv * head_dim, bias=bias, dtype=dtype, device=device)
        self.v = L.Linear(d_model, n_kv * head_dim, bias=bias, dtype=dtype, device=device)
        self.o = L.Linear(n_heads * head_dim, d_model, dtype=dtype, device=device)

    def reset(self, gen: torch.Generator) -> None:
        for lin in (self.q, self.k, self.v, self.o):
            lin.reset(gen)

    def forward(self, x: torch.Tensor, *, positions=None, rope_kind: str = "rope",
                rope_theta: float = 10000.0, mrope_sections=(16, 24, 24),
                causal: bool = True, cache: Optional[dict] = None, cache_pos=None,
                kv_override=None, impl: str = "blocked", block_q: int = 512,
                block_k: int = 1024):
        """Returns ``(out (B, T, d), new_cache or None)``.

        ``positions``: (B, T), or (B, T, 3) for ``rope_kind="mrope"``;
        ``cache``: ``{"k", "v"}`` of (B, S, n_kv, hd), written in place (see
        the module docstring); ``cache_pos``: the decode write position, a
        scalar or a (B,) vector (continuous batching). ``kv_override``:
        cross-attention's already projected ``(k, v)``, each (B, S, n_kv,
        hd); then no cache is read or written and no rotation applies.
        """
        b, t, _ = x.shape
        h, hkv, hd = self.n_heads, self.n_kv, self.head_dim
        q = self.q(x).reshape(b, t, h, hd)
        new_cache = None
        if kv_override is not None:
            k, v = kv_override
        else:
            k = self.k(x).reshape(b, t, hkv, hd)
            v = self.v(x).reshape(b, t, hkv, hd)
            if positions is not None and rope_kind != "none":
                if rope_kind == "mrope":
                    q = L.apply_mrope(q, positions, mrope_sections, rope_theta)
                    k = L.apply_mrope(k, positions, mrope_sections, rope_theta)
                else:
                    q = L.apply_rope(q, positions, rope_theta)
                    k = L.apply_rope(k, positions, rope_theta)
            if cache is not None:
                k_cache, v_cache = cache["k"], cache["v"]
                if t == 1:   # decode: write one step at cache_pos
                    _write_step(k_cache, k[:, 0], cache_pos)
                    _write_step(v_cache, v[:, 0], cache_pos)
                    k, v = k_cache, v_cache
                else:        # prefill: write the whole block at 0
                    k_cache[:, :t] = k
                    v_cache[:, :t] = v
                new_cache = {"k": k_cache, "v": v_cache}

        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if new_cache is not None and t == 1:
            # Decode against the cache with a validity length of cache_pos + 1.
            lens = torch.as_tensor(cache_pos, device=x.device) + 1
            out = fa_ops.decode_attention(qh, kh, vh, lens)
        else:
            out = _run_attention(qh, kh, vh, causal=causal, impl=impl,
                                 block_q=block_q, block_k=block_k)
        out = out.transpose(1, 2).reshape(b, t, h * hd)
        return self.o(out), new_cache


def _write_step(cache: torch.Tensor, row: torch.Tensor, cache_pos) -> None:
    """Write one decode step's ``row`` (B, ...) into ``cache`` (B, S, ...)
    at ``cache_pos``, a scalar or a (B,) vector (one position a lane)."""
    pos = torch.as_tensor(cache_pos, device=cache.device)
    if pos.dim() == 0:
        cache[:, int(pos)] = row
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.long()] = row.to(cache.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 Multi-head Latent Attention, kv_lora compressed cache)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """The reference's ``init_mla`` / ``mla_attention``: q through a LoRA
    (``q_down``, ``q_norm``, ``q_up``), k and v from a compressed ``c_kv``
    (``kv_down``, ``kv_norm``; ``k_up``, ``v_up`` per head) plus one rotary
    key ``k_pe`` shared by the heads, and ``o``. The cache holds ``c_kv``
    and ``k_pe`` only."""

    def __init__(self, d_model: int, n_heads: int, *, kv_lora: int = 512,
                 q_lora: int = 1536, qk_nope: int = 128, qk_rope: int = 64,
                 v_dim: int = 128, dtype=torch.float32, device=None):
        """Uninitialised weights on ``device`` (default: the current CUDA
        device; without one this raises)."""
        super().__init__()
        device = default_device(device, "MLA")
        self.n_heads, self.kv_lora = n_heads, kv_lora
        self.qk_nope, self.qk_rope, self.v_dim = qk_nope, qk_rope, v_dim
        kw = dict(dtype=dtype, device=device)
        self.q_down = L.Linear(d_model, q_lora, **kw)
        self.q_norm = L.RMSNorm(q_lora, **kw)
        self.q_up = L.Linear(q_lora, n_heads * (qk_nope + qk_rope), **kw)
        self.kv_down = L.Linear(d_model, kv_lora, **kw)
        self.kv_norm = L.RMSNorm(kv_lora, **kw)
        self.k_pe = L.Linear(d_model, qk_rope, **kw)
        self.k_up = L.Linear(kv_lora, n_heads * qk_nope, **kw)
        self.v_up = L.Linear(kv_lora, n_heads * v_dim, **kw)
        self.o = L.Linear(n_heads * v_dim, d_model, **kw)

    def reset(self, gen: torch.Generator) -> None:
        for lin in (self.q_down, self.q_up, self.kv_down, self.k_pe, self.k_up,
                    self.v_up, self.o):
            lin.reset(gen)
        self.q_norm.reset()
        self.kv_norm.reset()

    def forward(self, x: torch.Tensor, *, positions=None, rope_theta: float = 10000.0,
                causal: bool = True, cache: Optional[dict] = None, cache_pos=None,
                impl: str = "blocked", block_q: int = 512, block_k: int = 1024):
        """Returns ``(out (B, T, d), new_cache or None)``.

        ``cache``: ``{"c_kv" (B, S, kv_lora), "k_pe" (B, S, qk_rope)}``,
        written in place at ``cache_pos`` (decode; scalar or (B,)) or at 0
        (prefill). Decode attends in the compressed space (the absorbed
        form, float32): q is taken through ``k_up`` per head, the output
        through ``v_up``, and no per-head key or value is built for the
        cache. Train and prefill build per-head keys and values of
        ``qk_nope + qk_rope`` dims, pad v to that width for one attention
        call (``impl``: the flash kernel with "pallas"), and slice it back.
        """
        b, t, _ = x.shape
        hn, nope, rope, vd = self.n_heads, self.qk_nope, self.qk_rope, self.v_dim
        scale = (nope + rope) ** -0.5
        q = self.q_up(self.q_norm(self.q_down(x))).reshape(b, t, hn, nope + rope)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        c_kv = self.kv_norm(self.kv_down(x))                  # (B, T, kv_lora)
        k_pe = self.k_pe(x)                                   # (B, T, qk_rope)
        if positions is not None:
            q_pe = L.apply_rope(q_pe, positions, rope_theta)
            k_pe = L.apply_rope(k_pe, positions, rope_theta)

        new_cache = None
        if cache is not None:
            c_cache, pe_cache = cache["c_kv"], cache["k_pe"]
            if t == 1:
                _write_step(c_cache, c_kv[:, 0], cache_pos)
                _write_step(pe_cache, k_pe[:, 0], cache_pos)
            else:
                c_cache[:, :t] = c_kv
                pe_cache[:, :t] = k_pe
            new_cache = {"c_kv": c_cache, "k_pe": pe_cache}

        if new_cache is not None and t == 1:
            c_all, pe_all = new_cache["c_kv"].float(), new_cache["k_pe"].float()
            s = c_all.shape[1]
            wk = self.k_up.w.reshape(self.kv_lora, hn, nope).float()
            q_abs = torch.einsum("bthn,lhn->bthl", q_nope.float(), wk)
            logits = (torch.einsum("bthl,bsl->bhts", q_abs, c_all)
                      + torch.einsum("bthr,bsr->bhts", q_pe.float(), pe_all)) * scale
            lens = (torch.as_tensor(cache_pos, device=x.device) + 1).reshape(-1, 1)
            valid = torch.arange(s, device=x.device)[None, :] < lens
            logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            o_lat = torch.einsum("bhts,bsl->bthl", probs, c_all)
            wv = self.v_up.w.reshape(self.kv_lora, hn, vd).float()
            out = torch.einsum("bthl,lhv->bthv", o_lat, wv)
            return self.o(out.reshape(b, t, hn * vd).to(x.dtype)), new_cache

        k_nope = self.k_up(c_kv).reshape(b, t, hn, nope)
        v = self.v_up(c_kv).reshape(b, t, hn, vd)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, t, hn, rope)], dim=-1)
        qf = torch.cat([q_nope, q_pe], dim=-1)
        pad = nope + rope - vd
        if pad:
            v = F.pad(v, (0, pad))
        out = _run_attention(qf.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal, impl=impl, block_q=block_q, block_k=block_k)
        out = out.transpose(1, 2)[..., :vd].reshape(b, t, hn * vd)
        return self.o(out), new_cache
