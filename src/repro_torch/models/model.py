"""The decoder of the port: init, forward (train / prefill / decode), and
the KV cache.

The reference's ``repro.models.model`` for ``family="dense"`` and
``"moe"``: a stack of pre-norm decoder layers (self-attention + gated or
plain MLP, or an MoE layer) over an embedding, a final norm and an untied
LM head; an MoE config's ``first_k_dense`` dense layers come first. The
reference's ``lax.scan`` over stacked layer weights becomes a loop over
an ``nn.ModuleList``; its cache keeps the reference's layout, ``(layers,
batch, len, n_kv, head_dim)`` per key and value, because the serving
engine splices lanes on batch axis 1. The reference's mesh model axis,
over which MoE layers shard their experts, is ``ep_slots`` expert slots
stacked on the one device (:mod:`repro_torch.nn.moe`).

Every other family and feature of the reference (MLA, SSM, xLSTM,
encoder-decoder, vision patches, M-RoPE) raises ``NotImplementedError``
naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.device import default_device
from repro_torch.models.config import ModelConfig
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn.attention import Attention

__all__ = ["DecoderModel", "ForwardOut", "init_model", "forward", "init_cache",
           "check_supported", "dtype_of", "default_placements", "moe_capacity_for_shape"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    missing = []
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
    if cfg.family not in ("dense", "moe") and not missing:
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
    """Pre-norm self-attention + MLP (or MoE), each with a residual."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, moe_layer: bool = False,
                 d_ff_override: int = 0, ep_slots: int = 1):
        super().__init__()
        hd = cfg.resolved_head_dim()
        self.ln1 = L.make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, hd, bias=cfg.qkv_bias,
                              dtype=dtype, device=device)
        self.ln2 = L.make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.mlp = self.moe = None
        if moe_layer:
            self.moe = M.MoE(cfg.moe, ep_slots, dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg.d_model, d_ff_override or cfg.d_ff, gated=cfg.gated_mlp,
                           act=cfg.act, dtype=dtype, device=device)

    def reset(self, gen: torch.Generator) -> None:
        self.ln1.reset()
        self.attn.reset(gen)
        self.ln2.reset()
        (self.moe or self.mlp).reset(gen)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None, cache_pos=None,
                placement=None, moe_capacity=None):
        """Returns ``(x, new_cache, stats)``; ``cache`` is ``{"self": {"k",
        "v"}}``, ``stats`` an MoE layer's (else empty). ``cfg`` picks the
        attention path (``attn_impl`` and its blocks)."""
        attn_out, new_cache = self.attn(
            self.ln1(x), positions=positions, rope_kind=cfg.rope_kind,
            rope_theta=cfg.rope_theta, causal=True,
            cache=cache["self"] if cache else None, cache_pos=cache_pos,
            impl=cfg.attn_impl, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        x = x + attn_out
        stats = {}
        if self.moe is not None:
            y, stats = self.moe(self.ln2(x), placement=placement, capacity=moe_capacity)
        else:
            y = self.mlp(self.ln2(x))
        x = x + y
        return x, ({"self": new_cache} if new_cache is not None else {}), stats


def _n_dense(cfg: ModelConfig) -> int:
    return cfg.first_k_dense if cfg.moe is not None else 0


class DecoderModel(nn.Module):
    """Embedding, ``first_k_dense`` dense layers (MoE configs), the
    ``layers`` stack (MoE layers for an MoE config), final norm, LM head."""

    def __init__(self, cfg: ModelConfig, *, device=None, ep_slots: int = 1):
        """Uninitialised weights on ``device`` (default: the current CUDA
        device; without one this raises); MoE layers over ``ep_slots``
        stacked expert slots."""
        super().__init__()
        check_supported(cfg)
        device = default_device(device, "DecoderModel")
        dtype = dtype_of(cfg.param_dtype)
        self.ep_slots = ep_slots
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, dtype=dtype, device=device)
        self.final_norm = L.make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.lm_head = L.Linear(cfg.d_model, cfg.vocab, dtype=dtype, device=device)
        n_dense = _n_dense(cfg)
        self.dense_layers = nn.ModuleList(
            DecoderLayer(cfg, dtype=dtype, device=device, d_ff_override=cfg.first_dense_ff)
            for _ in range(n_dense))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype=dtype, device=device, moe_layer=cfg.moe is not None,
                         ep_slots=ep_slots)
            for _ in range(cfg.n_layers - n_dense))

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               generator: Optional[torch.Generator] = None,
               ep_slots: int = 1) -> DecoderModel:
    """Random weights with the reference's distributions and scales.

    Linear weights ``normal * d_in^-0.5``, embeddings ``normal * d^-0.5``,
    norm scales 1 and biases 0, drawn in float32 from ``generator`` (default:
    a ``torch.Generator`` on ``device`` seeded with ``seed``) and cast to
    ``cfg.param_dtype``, on ``device`` (default: the current CUDA device;
    without one this raises). MoE layers hold their experts over
    ``ep_slots`` stacked expert slots (the reference's model axis). The
    draws are not the reference's (JAX's keys differ); ``models.convert``
    loads the reference's own values.
    """
    model = DecoderModel(cfg, device=device, ep_slots=ep_slots)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    model.embed.reset(generator)
    model.final_norm.reset()
    model.lm_head.reset(generator)
    for layer in (*model.dense_layers, *model.layers):
        layer.reset(generator)
    return model


# ---------------------------------------------------------------------------
# MoE plan helpers
# ---------------------------------------------------------------------------


def _n_moe_layers(cfg: ModelConfig) -> int:
    if cfg.moe is None:
        return 0
    return cfg.n_layers - cfg.first_k_dense


def default_placements(cfg: ModelConfig, ep_slots: int = 1, device=None):
    """(L_moe, 2, E) baseline placement table (eq. 3-1 class), or None."""
    n = _n_moe_layers(cfg)
    if n == 0:
        return None
    one = M.default_placement(cfg.moe, ep_slots, device=device)
    return one.expand((n,) + tuple(one.shape))


def moe_capacity_for_shape(cfg: ModelConfig, shape_batch: int, shape_seq: int,
                           ep_slots: int = 1, max_load_ratio: float = 1.0) -> Optional[int]:
    """Static dispatch capacity for (batch, seq) — strategy-aware."""
    if cfg.moe is None:
        return None
    a2a = (cfg.moe.strategy == "a2a" and cfg.moe.is_ep(ep_slots)
           and shape_seq % ep_slots == 0 and shape_seq > 1)
    if a2a:
        tokens = shape_batch * (shape_seq // ep_slots)
    else:
        tokens = max(1, shape_batch) * shape_seq
    cap = M.capacity_for(cfg.moe, tokens, ep_slots, max_load_ratio)
    return min(cap, tokens * cfg.moe.top_k)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ForwardOut:
    logits: torch.Tensor
    cache: Any = None
    stats: Optional[dict] = None


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
            cache=None, cache_pos=None, placements=None,
            moe_capacity: Optional[int] = None) -> ForwardOut:
    """Logits of ``tokens (B, T)``, with a ``cache`` the new cache, and
    ``stats``: ``aux_loss``, and for an MoE config ``expert_counts``
    ``(L_moe, E)`` and the summed ``overflow`` (device tensors).

    ``mode="prefill"`` with a cache writes the prompt's keys and values at
    positions ``0..T-1`` of a copy of the cache (the caller's cache is left
    as it was, as the reference's functional update leaves it);
    ``mode="decode"`` writes one step at ``cache_pos`` (scalar or per-lane)
    into the given cache, in place, and returns it. ``placements`` is the
    ``(L_moe, 2, E)`` table of the OS4M expert balancer (default: the hash
    baseline) and ``moe_capacity`` the static dispatch capacity (default:
    each layer's :func:`repro_torch.nn.moe.capacity_for`).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    check_supported(cfg)
    return _forward_decoder(model, cfg, tokens, mode, cache, cache_pos, placements,
                            moe_capacity)


def _stack_cache(part: Optional[dict], mode: str) -> Optional[dict]:
    """A cache part for this forward: a copy unless decoding (in place)."""
    if part is None:
        return None
    kv = part["self"]
    if mode != "decode":
        kv = {"k": kv["k"].clone(), "v": kv["v"].clone()}
    return {"self": kv}


def _run_stack(layers, part, x, cfg, positions, cache_pos, placements=None,
               moe_capacity=None):
    """Run a layer stack over ``x``; the MoE layers' stats, one a layer."""
    stats = []
    for i, layer in enumerate(layers):
        lcache = None if part is None else {
            "self": {"k": part["self"]["k"][i], "v": part["self"]["v"][i]}}
        x, _, st = layer(x, cfg, positions=positions, cache=lcache, cache_pos=cache_pos,
                         placement=None if placements is None else placements[i],
                         moe_capacity=moe_capacity)
        stats.append(st)
    return x, stats


def _forward_decoder(model, cfg, tokens, mode, cache, cache_pos, placements,
                     moe_capacity) -> ForwardOut:
    x = _embed_inputs(model, cfg, tokens)
    b, t, _ = x.shape
    start = cache_pos if mode == "decode" else 0
    positions = _positions(b, t, start=start, device=x.device)
    is_moe = cfg.moe is not None
    if is_moe and placements is None:
        placements = default_placements(cfg, model.ep_slots, device=x.device)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": _stack_cache(cache["layers"], mode)}
        if "dense" in cache:
            new_cache["dense"] = _stack_cache(cache["dense"], mode)
    if len(model.dense_layers):
        x, _ = _run_stack(model.dense_layers, None if new_cache is None else new_cache["dense"],
                          x, cfg, positions, cache_pos)
    x, layer_stats = _run_stack(model.layers, None if new_cache is None else new_cache["layers"],
                                x, cfg, positions, cache_pos,
                                placements if is_moe else None, moe_capacity)
    stats = {"aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}
    if is_moe:
        stats["aux_loss"] = torch.stack([st["aux_loss"] for st in layer_stats]).sum()
        stats["expert_counts"] = torch.stack([st["counts"] for st in layer_stats])
        stats["overflow"] = torch.stack([st["overflow"] for st in layer_stats]).sum()
    logits = _lm_head(model, cfg, x)
    return ForwardOut(logits=logits, cache=new_cache, stats=stats)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zeroed cache for ``batch`` sequences of up to ``max_len`` tokens:
    ``{"layers": {"self": {"k", "v"}}}``, each ``(layers, batch, max_len,
    n_kv, head_dim)``, and for an MoE config with leading dense layers a
    ``"dense"`` part of theirs, on ``device`` (default: the current CUDA
    device; without one this raises)."""
    check_supported(cfg)
    device = default_device(device, "init_cache")

    def kv(layers: int) -> dict:
        shape = (layers, batch, max_len, cfg.n_kv, cfg.resolved_head_dim())
        return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}}

    n_dense = _n_dense(cfg)
    out = {"layers": kv(cfg.n_layers - n_dense)}
    if n_dense:
        out["dense"] = kv(n_dense)
    return out
