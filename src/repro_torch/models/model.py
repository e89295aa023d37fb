"""The dense decoder of the port: init, forward (train / prefill / decode),
and the KV cache.

The reference's ``repro.models.model`` for ``family="dense"``: a stack of
pre-norm decoder layers (self-attention + gated or plain MLP) over an
embedding, a final norm and an untied LM head. The reference's
``lax.scan`` over stacked layer weights becomes a loop over an
``nn.ModuleList``; its cache keeps the reference's layout, ``(layers,
batch, len, n_kv, head_dim)`` per key and value, because the serving
engine splices lanes on batch axis 1.

Every other family and feature of the reference (MoE layers, MLA, SSM,
xLSTM, encoder-decoder, vision patches, M-RoPE) raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.device import default_device
from repro_torch.models.config import ModelConfig
from repro_torch.nn import layers as L
from repro_torch.nn.attention import Attention

__all__ = ["DecoderModel", "ForwardOut", "init_model", "forward", "init_cache",
           "check_supported", "dtype_of"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    missing = []
    if cfg.moe is not None:
        missing.append(("MoE layers (moe=...)", 11))
    for field, value in (("mla", cfg.mla), ("ssm", cfg.ssm), ("xlstm", cfg.xlstm)):
        if value is not None:
            missing.append((f"{field}=...", 12))
    if cfg.enc_dec:
        missing.append(("enc_dec=True (the whisper family)", 12))
    if cfg.n_patches:
        missing.append(("n_patches > 0 (the vlm family)", 12))
    if cfg.abs_pos:
        missing.append(("abs_pos=True (sinusoidal positions)", 12))
    if cfg.rope_kind not in ("rope", "none"):
        missing.append((f"rope_kind={cfg.rope_kind!r}", 12))
    if cfg.family != "dense" and not missing:
        missing.append((f"family={cfg.family!r}", 12))
    if missing:
        what = "; ".join(f"{name} (ROADMAP item {item})" for name, item in missing)
        raise NotImplementedError(f"{cfg.name}: not ported yet: {what}")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``down(act(gate(x)) * up(x))``, or ``down(act(up(x)))`` ungated."""

    def __init__(self, d: int, d_ff: int, *, gated: bool, act: str, dtype, device):
        super().__init__()
        self.act = act
        self.up = L.Linear(d, d_ff, dtype=dtype, device=device)
        self.down = L.Linear(d_ff, d, dtype=dtype, device=device)
        self.gate = L.Linear(d, d_ff, dtype=dtype, device=device) if gated else None

    def reset(self, gen: torch.Generator) -> None:
        for lin in (self.up, self.down, self.gate):
            if lin is not None:
                lin.reset(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(x)
        if self.gate is not None:
            h = L.ACTIVATIONS[self.act](self.gate(x)) * h
        else:
            h = L.ACTIVATIONS[self.act](h)
        return self.down(h)


class DecoderLayer(nn.Module):
    """Pre-norm self-attention + MLP, each with a residual."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        hd = cfg.resolved_head_dim()
        self.ln1 = L.make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, hd, bias=cfg.qkv_bias,
                              dtype=dtype, device=device)
        self.ln2 = L.make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, act=cfg.act,
                       dtype=dtype, device=device)

    def reset(self, gen: torch.Generator) -> None:
        self.ln1.reset()
        self.attn.reset(gen)
        self.ln2.reset()
        self.mlp.reset(gen)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None, cache_pos=None):
        """Returns ``(x, new_cache)``; ``cache`` is ``{"self": {"k", "v"}}``.
        ``cfg`` picks the attention path (``attn_impl`` and its blocks)."""
        attn_out, new_cache = self.attn(
            self.ln1(x), positions=positions, rope_kind=cfg.rope_kind,
            rope_theta=cfg.rope_theta, causal=True,
            cache=cache["self"] if cache else None, cache_pos=cache_pos,
            impl=cfg.attn_impl, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        x = x + attn_out
        x = x + self.mlp(self.ln2(x))
        return x, ({"self": new_cache} if new_cache is not None else {})


class DecoderModel(nn.Module):
    """Embedding, ``n_layers`` decoder layers, final norm, LM head."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        """Uninitialised weights on ``device`` (default: the current CUDA
        device; without one this raises)."""
        super().__init__()
        check_supported(cfg)
        device = default_device(device, "DecoderModel")
        dtype = dtype_of(cfg.param_dtype)
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, dtype=dtype, device=device)
        self.final_norm = L.make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.lm_head = L.Linear(cfg.d_model, cfg.vocab, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype=dtype, device=device) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               generator: Optional[torch.Generator] = None) -> DecoderModel:
    """Random weights with the reference's distributions and scales.

    Linear weights ``normal * d_in^-0.5``, embeddings ``normal * d^-0.5``,
    norm scales 1 and biases 0, drawn in float32 from ``generator`` (default:
    a ``torch.Generator`` on ``device`` seeded with ``seed``) and cast to
    ``cfg.param_dtype``, on ``device`` (default: the current CUDA device;
    without one this raises). The draws are not the reference's (JAX's keys
    differ); ``models.convert`` loads the reference's own values.
    """
    model = DecoderModel(cfg, device=device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    model.embed.reset(generator)
    model.final_norm.reset()
    model.lm_head.reset(generator)
    for layer in model.layers:
        layer.reset(generator)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ForwardOut:
    logits: torch.Tensor
    cache: Any = None


def _positions(b: int, t: int, start=0, device=None) -> torch.Tensor:
    """(B, T) position ids. ``start`` may be a scalar or a per-lane (B,)
    vector (continuous batching)."""
    start = torch.as_tensor(start, device=device)
    steps = torch.arange(t, device=device)
    if start.dim() > 0:
        base = start.long()[:, None] + steps            # (B, t)
    else:
        base = start.long() + steps                     # (t,)
    return base.expand(b, t)


def _embed_inputs(model: DecoderModel, cfg: ModelConfig, tokens) -> torch.Tensor:
    return model.embed(tokens).to(dtype_of(cfg.compute_dtype))


def _lm_head(model: DecoderModel, cfg: ModelConfig, x) -> torch.Tensor:
    return model.lm_head(model.final_norm(x)).to(dtype_of(cfg.logit_dtype))


def forward(model: DecoderModel, cfg: ModelConfig, *, tokens, mode: str = "train",
            cache=None, cache_pos=None) -> ForwardOut:
    """Logits of ``tokens (B, T)`` and, with a ``cache``, the new cache.

    ``mode="prefill"`` with a cache writes the prompt's keys and values at
    positions ``0..T-1`` of a copy of the cache (the caller's cache is left
    as it was, as the reference's functional update leaves it);
    ``mode="decode"`` writes one step at ``cache_pos`` (scalar or per-lane)
    into the given cache, in place, and returns it.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    check_supported(cfg)
    return _forward_decoder(model, cfg, tokens, mode, cache, cache_pos)


def _forward_decoder(model, cfg, tokens, mode, cache, cache_pos) -> ForwardOut:
    x = _embed_inputs(model, cfg, tokens)
    b, t, _ = x.shape
    start = cache_pos if mode == "decode" else 0
    positions = _positions(b, t, start=start, device=x.device)
    new_cache = None
    if cache is not None:
        kv = cache["layers"]["self"]
        if mode != "decode":
            kv = {"k": kv["k"].clone(), "v": kv["v"].clone()}
        new_cache = {"layers": {"self": kv}}
    for i, layer in enumerate(model.layers):
        lcache = None if new_cache is None else {
            "self": {"k": new_cache["layers"]["self"]["k"][i],
                     "v": new_cache["layers"]["self"]["v"][i]}}
        x, _ = layer(x, cfg, positions=positions, cache=lcache, cache_pos=cache_pos)
    logits = _lm_head(model, cfg, x)
    return ForwardOut(logits=logits, cache=new_cache)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zeroed cache for ``batch`` sequences of up to ``max_len`` tokens:
    ``{"layers": {"self": {"k", "v"}}}``, each ``(layers, batch, max_len,
    n_kv, head_dim)``, on ``device`` (default: the current CUDA device;
    without one this raises)."""
    check_supported(cfg)
    device = default_device(device, "init_cache")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.resolved_head_dim())
    return {"layers": {"self": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }}}
