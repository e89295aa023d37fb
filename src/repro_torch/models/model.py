"""The decoder of the port: init, forward (train / prefill / decode), and
the KV cache.

The reference's ``repro.models.model`` for the families its serving
engine serves:

* ``dense`` / ``moe`` / ``vlm``: a stack of pre-norm decoder layers
  (self-attention, GQA or DeepSeek-V2's MLA, + gated or plain MLP, or an
  MoE layer) over an embedding, a final norm and an untied LM head; an MoE
  config's ``first_k_dense`` dense layers come first; a vlm config
  prepends its patch embeddings (``extra_embed``) to the text and rotates
  by M-RoPE;
* whisper (``enc_dec``): an encoder stack over the frame embeddings
  (``extra_embed``), non-causal, with sinusoidal positions, then decoder
  layers that add cross-attention over each layer's projection of the
  encoder output;

and for the state-based families, which decode from a recurrent state:

* zamba2 (``ssm``): groups of ``attn_every`` pre-norm Mamba2 layers, each
  group followed by one shared attention + MLP decoder layer (a single set
  of weights, applied once a group, with a KV cache of its own per group);
* xLSTM (``xlstm``): groups of ``slstm_every - 1`` mLSTM layers and one
  sLSTM layer.

The reference's ``lax.scan`` over stacked layer weights becomes a loop
over an ``nn.ModuleList``; its cache keeps the reference's layout, ``(layers,
batch, len, n_kv, head_dim)`` per key and value (MLA: ``(layers, batch,
len, kv_lora)`` and ``(..., qk_rope)``; whisper adds the cross keys and
values as a tuple), because the serving engine splices lanes on batch
axis 1. The reference's mesh model axis, over which MoE layers shard their
experts, is ``ep_slots`` expert slots stacked on the one device
(:mod:`repro_torch.nn.moe`).

Training: ``forward(mode="train")`` runs under autograd once the
model's weights require a gradient (``model.requires_grad_(True)``);
with ``cfg.remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of each
scan body), and :func:`lm_loss` is the reference's token cross-entropy.

The state-based families keep the reference's cache trees: zamba2's
``{"mamba": {"ssm" (groups, k, B, H, P, N), "conv" (groups, k, B, K-1,
conv_dim)}, "attn": {"self": {"k", "v"}}}`` (the shared block's keys and
values per group, ``(groups, B, max_len, n_kv, hd)``), xLSTM's ``{"mlstm":
{"cell": (C, n, m), "conv"}, "slstm": (h, c, n, m)}`` stacked on ``(groups,
per - 1)`` and ``(groups,)``; states are float32. A prefill starts every
state from zero (the sLSTM from the cache it is given, as the reference)
and returns fresh states; a decode step writes the new states into the
cache it is given, in place, as it writes keys and values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import default_device
from repro_torch.models.config import ModelConfig
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import ssm as S
from repro_torch.nn import xlstm as X
from repro_torch.nn.attention import MLA, Attention

__all__ = ["DecoderModel", "ForwardOut", "init_model", "forward", "lm_loss", "init_cache",
           "check_supported", "dtype_of", "default_placements", "moe_capacity_for_shape",
           "MambaLayer", "MLSTMLayer", "SLSTMLayer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    missing = []
    if cfg.rope_kind not in ("rope", "mrope", "none"):
        missing.append((f"rope_kind={cfg.rope_kind!r}", 12))
    if cfg.family not in ("dense", "moe", "vlm", "audio", "ssm", "hybrid"):
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
    """Pre-norm self-attention (GQA or MLA), optional cross-attention, and
    an MLP (or MoE), each with a residual."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, moe_layer: bool = False,
                 cross: bool = False, d_ff_override: int = 0, ep_slots: int = 1):
        super().__init__()
        hd = cfg.resolved_head_dim()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.make_norm(cfg.norm, cfg.d_model, **kw)
        if cfg.mla is not None:
            m = cfg.mla
            self.attn = MLA(cfg.d_model, cfg.n_heads, kv_lora=m.kv_lora, q_lora=m.q_lora,
                            qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_dim=m.v_dim, **kw)
        else:
            self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, hd, bias=cfg.qkv_bias,
                                  **kw)
        self.ln_x = self.xattn = None
        if cross:
            self.ln_x = L.make_norm(cfg.norm, cfg.d_model, **kw)
            self.xattn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, hd, bias=cfg.qkv_bias,
                                   **kw)
        self.ln2 = L.make_norm(cfg.norm, cfg.d_model, **kw)
        self.mlp = self.moe = None
        if moe_layer:
            self.moe = M.MoE(cfg.moe, ep_slots, **kw)
        else:
            self.mlp = MLP(cfg.d_model, d_ff_override or cfg.d_ff, gated=cfg.gated_mlp,
                           act=cfg.act, **kw)

    def reset(self, gen: torch.Generator) -> None:
        self.ln1.reset()
        self.attn.reset(gen)
        if self.xattn is not None:
            self.ln_x.reset()
            self.xattn.reset(gen)
        self.ln2.reset()
        (self.moe or self.mlp).reset(gen)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None, cache_pos=None,
                enc_kv=None, causal_self: bool = True, placement=None, moe_capacity=None):
        """Returns ``(x, new_cache, stats)``; ``cache`` is ``{"self": {"k",
        "v"}}`` (MLA: ``{"c_kv", "k_pe"}``), ``enc_kv`` the cross-attention's
        ``(k, v)`` of this layer, ``stats`` an MoE layer's (else empty).
        ``cfg`` picks the attention path (``attn_impl`` and its blocks)."""
        common = dict(positions=positions, rope_theta=cfg.rope_theta, causal=causal_self,
                      cache=cache["self"] if cache else None, cache_pos=cache_pos,
                      impl=cfg.attn_impl, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        if isinstance(self.attn, MLA):
            attn_out, new_cache = self.attn(self.ln1(x), **common)
        else:
            attn_out, new_cache = self.attn(self.ln1(x), rope_kind=cfg.rope_kind,
                                            mrope_sections=cfg.mrope_sections, **common)
        x = x + attn_out
        if enc_kv is not None:
            xo, _ = self.xattn(self.ln_x(x), positions=None, rope_kind="none", causal=False,
                               kv_override=enc_kv, impl=cfg.attn_impl,
                               block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
            x = x + xo
        stats = {}
        if self.moe is not None:
            y, stats = self.moe(self.ln2(x), placement=placement, capacity=moe_capacity)
        else:
            y = self.mlp(self.ln2(x))
        x = x + y
        return x, ({"self": new_cache} if new_cache is not None else {}), stats


class _MixerLayer(nn.Module):
    """A pre-norm ``ln`` and a ``mixer``: ``x + mixer(ln(x))``."""

    def __init__(self, cfg: ModelConfig, mixer: nn.Module, *, dtype, device):
        super().__init__()
        self.ln = L.make_norm(cfg.norm, cfg.d_model, dtype=dtype, device=device)
        self.mixer = mixer

    def reset(self, gen: torch.Generator) -> None:
        self.ln.reset()
        self.mixer.reset(gen)


class MambaLayer(_MixerLayer):
    """The reference's ``init_mamba_layer``: ``ln`` and a Mamba2 mixer."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__(cfg, S.Mamba2(cfg.ssm, dtype=dtype, device=device), dtype=dtype,
                         device=device)

    def forward(self, x, mode: str, state=None):
        """``(x + y, new_state)``: decode steps from ``state``; prefill
        starts from zero and returns its state; train returns None."""
        h = self.ln(x)
        if mode == "decode":
            y, new = S.mamba2_decode(self.mixer, h, state)
        elif mode == "prefill":
            y, new = S.mamba2(self.mixer, h, return_state=True)
        else:
            y, new = S.mamba2(self.mixer, h), None
        return x + y, new


class MLSTMLayer(_MixerLayer):
    """The reference's ``init_mlstm_layer``: ``ln`` and an mLSTM mixer."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__(cfg, X.MLSTM(cfg.xlstm, dtype=dtype, device=device), dtype=dtype,
                         device=device)

    def forward(self, x, mode: str, state=None):
        """As :meth:`MambaLayer.forward`, with the mLSTM's state."""
        h = self.ln(x)
        if mode == "decode":
            y, new = X.mlstm_decode(self.mixer, h, state)
        elif mode == "prefill":
            y, new = X.mlstm(self.mixer, h, return_state=True)
        else:
            y, new = X.mlstm(self.mixer, h), None
        return x + y, new


class SLSTMLayer(_MixerLayer):
    """The reference's ``init_slstm_layer``: ``ln`` and an sLSTM mixer."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__(cfg, X.SLSTM(cfg.xlstm, dtype=dtype, device=device), dtype=dtype,
                         device=device)

    def forward(self, x, mode: str, state=None):
        """``(x + y, new_state)``; prefill and decode run from ``state``
        (None: the zero state) and return the final one."""
        h = self.ln(x)
        if mode == "train":
            return x + X.slstm(self.mixer, h), None
        y, new = X.slstm(self.mixer, h, state=state, return_state=True)
        return x + y, new


def _n_dense(cfg: ModelConfig) -> int:
    return cfg.first_k_dense if cfg.moe is not None else 0


def _groups(cfg: ModelConfig) -> tuple:
    """``(groups, layers a group)`` of a state-based stack: zamba2's Mamba2
    layers between shared attention blocks, xLSTM's mLSTM + sLSTM layers."""
    per = (cfg.slstm_every if cfg.xlstm is not None else cfg.attn_every) or cfg.n_layers
    return cfg.n_layers // per, per


class DecoderModel(nn.Module):
    """Embedding, ``first_k_dense`` dense layers (MoE configs), the
    ``layers`` stack (MoE layers for an MoE config; whisper's decoder
    layers, with cross-attention, after its ``enc_layers`` and
    ``enc_norm``), final norm, LM head. A state-based config has no
    ``layers``: zamba2 has ``mamba[g][i]`` and ``shared_attn``, xLSTM
    ``mlstm[g][i]`` and ``slstm[g]``."""

    def __init__(self, cfg: ModelConfig, *, device=None, ep_slots: int = 1):
        """Uninitialised weights on ``device`` (default: the current CUDA
        device; without one this raises); MoE layers over ``ep_slots``
        stacked expert slots."""
        super().__init__()
        check_supported(cfg)
        device = default_device(device, "DecoderModel")
        dtype = dtype_of(cfg.param_dtype)
        kw = dict(dtype=dtype, device=device)
        self.ep_slots = ep_slots
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, **kw)
        self.final_norm = L.make_norm(cfg.norm, cfg.d_model, **kw)
        self.lm_head = L.Linear(cfg.d_model, cfg.vocab, **kw)
        n_dense = _n_dense(cfg)
        self.dense_layers = nn.ModuleList(
            DecoderLayer(cfg, d_ff_override=cfg.first_dense_ff, **kw) for _ in range(n_dense))
        self.enc_layers = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.n_enc_layers if cfg.enc_dec else 0))
        self.enc_norm = L.make_norm(cfg.norm, cfg.d_model, **kw) if cfg.enc_dec else None
        state_based = cfg.ssm is not None or cfg.xlstm is not None
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, moe_layer=cfg.moe is not None, cross=cfg.enc_dec,
                         ep_slots=ep_slots, **kw)
            for _ in range(0 if state_based else cfg.n_layers - n_dense))
        # State-based stacks, group by group: zamba2's Mamba2 layers and its
        # one shared attention block; xLSTM's mLSTM layers and sLSTMs.
        self.mamba = self.mlstm = self.slstm = self.shared_attn = None
        if cfg.xlstm is not None:
            groups, per = _groups(cfg)
            self.mlstm = nn.ModuleList(
                nn.ModuleList(MLSTMLayer(cfg, **kw) for _ in range(per - 1))
                for _ in range(groups))
            self.slstm = nn.ModuleList(SLSTMLayer(cfg, **kw) for _ in range(groups))
        elif cfg.ssm is not None:
            groups, per = _groups(cfg)
            self.mamba = nn.ModuleList(
                nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(per)) for _ in range(groups))
            if cfg.attn_every:
                self.shared_attn = DecoderLayer(cfg, **kw)

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
    for layer in (*model.dense_layers, *model.enc_layers, *model.layers):
        layer.reset(generator)
    for group in (*(model.mamba or ()), *(model.mlstm or ())):
        for layer in group:
            layer.reset(generator)
    for layer in (*(model.slstm or ()), *filter(None, [model.shared_attn])):
        layer.reset(generator)
    if model.enc_norm is not None:
        model.enc_norm.reset()
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


def _positions(cfg: ModelConfig, b: int, t: int, start=0, device=None) -> torch.Tensor:
    """(B, T) position ids, or (B, T, 3) for M-RoPE. ``start`` may be a
    scalar or a per-lane (B,) vector (continuous batching).

    M-RoPE (the vlm family): stream position ``idx < n_patches`` is a patch
    at grid ``(0, idx // patch_grid, idx % patch_grid)``; text continues
    from ``idx - n_patches + 1`` in all three."""
    start = torch.as_tensor(start, device=device)
    steps = torch.arange(t, device=device)
    if start.dim() > 0:
        base = start.long()[:, None] + steps            # (B, t)
    else:
        base = start.long() + steps                     # (t,)
    if cfg.rope_kind != "mrope":
        return base.expand(b, t)
    npch, g = cfg.n_patches, cfg.patch_grid
    is_text = base >= npch
    text = base - npch + 1
    p3 = torch.stack([torch.where(is_text, text, 0), torch.where(is_text, text, base // g),
                      torch.where(is_text, text, base % g)], dim=-1)
    return p3.expand(b, t, 3)


def _embed_inputs(model: DecoderModel, cfg: ModelConfig, tokens, extra_embed=None
                  ) -> torch.Tensor:
    """Token embeddings in the compute type; a vlm config's patch embeddings
    ``extra_embed`` (B, P, d) in front; sinusoidal positions with
    ``abs_pos``."""
    x = model.embed(tokens).to(dtype_of(cfg.compute_dtype))
    if cfg.n_patches and extra_embed is not None:
        x = torch.cat([torch.as_tensor(extra_embed, device=x.device).to(x.dtype), x], dim=1)
    if cfg.abs_pos:
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device).to(x.dtype)
    return x


def _lm_head(model: DecoderModel, cfg: ModelConfig, x) -> torch.Tensor:
    return model.lm_head(model.final_norm(x)).to(dtype_of(cfg.logit_dtype))


def forward(model: DecoderModel, cfg: ModelConfig, *, tokens, extra_embed=None,
            mode: str = "train", cache=None, cache_pos=None, placements=None,
            moe_capacity: Optional[int] = None) -> ForwardOut:
    """Logits of ``tokens (B, T)``, with a ``cache`` the new cache, and
    ``stats``: ``aux_loss``, and for an MoE config ``expert_counts``
    ``(L_moe, E)`` and the summed ``overflow`` (device tensors); whisper's
    ``stats`` is None, as the reference's.

    ``extra_embed``: a vlm config's patch embeddings (B, n_patches, d),
    put in front of the text (not while decoding), or whisper's frame
    embeddings (B, enc_len, d), which its train and prefill modes need.
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
    if cfg.enc_dec:
        return _forward_whisper(model, cfg, tokens, extra_embed, mode, cache, cache_pos)
    if cfg.xlstm is not None:
        return _forward_xlstm(model, cfg, tokens, mode, cache)
    if cfg.ssm is not None:
        return _forward_zamba(model, cfg, tokens, mode, cache, cache_pos)
    return _forward_decoder(model, cfg, tokens, extra_embed, mode, cache, cache_pos,
                            placements, moe_capacity)


def _stack_cache(part: Optional[dict], mode: str) -> Optional[dict]:
    """A cache part for this forward: a copy unless decoding (in place)."""
    if part is None:
        return None
    kv = part["self"]
    if mode != "decode":
        kv = {name: a.clone() for name, a in kv.items()}
    return {"self": kv}


def _remat(layer, cfg: ModelConfig, cache) -> bool:
    """Whether to recompute ``layer`` in the backward: ``cfg.remat``, a
    gradient being recorded for its weights, and no cache written."""
    return (cfg.remat and cache is None and torch.is_grad_enabled()
            and next(layer.parameters()).requires_grad)


def _run_stack(layers, part, x, cfg, positions, cache_pos, placements=None,
               moe_capacity=None, enc_kv=None, causal_self=True):
    """Run a layer stack over ``x``; the MoE layers' stats, one a layer.
    ``enc_kv``: the stacked cross ``(k, v)``, each (layers, B, S, n_kv, hd).

    Under remat a layer's recomputation in the backward re-runs its routing
    too, but the stats kept are the first forward's outputs: nothing is
    counted twice."""
    stats = []
    for i, layer in enumerate(layers):
        lcache = None if part is None else {
            "self": {name: a[i] for name, a in part["self"].items()}}
        kw = dict(positions=positions, cache=lcache, cache_pos=cache_pos,
                  enc_kv=None if enc_kv is None else (enc_kv[0][i], enc_kv[1][i]),
                  causal_self=causal_self,
                  placement=None if placements is None else placements[i],
                  moe_capacity=moe_capacity)
        if _remat(layer, cfg, lcache):
            x, _, st = checkpoint(layer, x, cfg, use_reentrant=False,
                                  preserve_rng_state=False, **kw)
        else:
            x, _, st = layer(x, cfg, **kw)
        stats.append(st)
    return x, stats


def _forward_decoder(model, cfg, tokens, extra_embed, mode, cache, cache_pos, placements,
                     moe_capacity) -> ForwardOut:
    x = _embed_inputs(model, cfg, tokens, extra_embed if mode != "decode" else None)
    b, t, _ = x.shape
    start = cache_pos if mode == "decode" else 0
    positions = _positions(cfg, b, t, start=start, device=x.device)
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


def _forward_whisper(model, cfg, tokens, frames, mode, cache, cache_pos) -> ForwardOut:
    """The reference's ``_forward_whisper``: the encoder over ``frames``
    (train, prefill) or the cross keys and values of ``cache["cross"]``
    (decode), then the decoder with sinusoidal positions (gathered at
    ``cache_pos`` from a ``max_len`` table when decoding)."""
    hd = cfg.resolved_head_dim()
    dtype = dtype_of(cfg.compute_dtype)
    dev = model.device
    if mode == "decode":
        enc_kv = cache["cross"]                          # (L, B, S_enc, kv, hd) x2
    else:
        if frames is None:
            # The reference fails here too (None has no ``astype``).
            raise AttributeError(
                f"{cfg.name}: {mode} needs the frame embeddings (extra_embed of shape "
                f"(B, {cfg.enc_len}, {cfg.d_model}))")
        enc = torch.as_tensor(frames, device=dev).to(dtype)
        enc = enc + L.sinusoidal_positions(enc.shape[1], cfg.d_model, device=dev).to(dtype)
        enc, _ = _run_stack(model.enc_layers, None, enc, cfg, None, None, causal_self=False)
        enc_out = model.enc_norm(enc)
        b, s = enc_out.shape[:2]
        enc_kv = tuple(
            torch.stack([getattr(layer.xattn, name)(enc_out).reshape(b, s, cfg.n_kv, hd)
                         for layer in model.layers])
            for name in ("k", "v"))

    x = model.embed(tokens).to(dtype)
    b, t, _ = x.shape
    if mode == "decode":
        max_len = int(cache["dec"]["self"]["k"].shape[2])
        pos = torch.as_tensor(cache_pos, device=dev)
        steps = torch.arange(t, device=dev)
        idx = pos.long()[:, None] + steps if pos.dim() > 0 else pos.long() + steps
        x = x + L.sinusoidal_positions(max_len, cfg.d_model, device=dev)[idx].to(dtype)
    else:
        x = x + L.sinusoidal_positions(t, cfg.d_model, device=dev).to(dtype)
    part = None if cache is None else _stack_cache(cache["dec"], mode)
    x, _ = _run_stack(model.layers, part, x, cfg, None, cache_pos, enc_kv=enc_kv)
    logits = _lm_head(model, cfg, x)
    new_cache = None if cache is None else {"dec": part, "cross": enc_kv}
    return ForwardOut(logits=logits, cache=new_cache, stats=None)


def _state_layer(layer, cfg: ModelConfig, x, mode: str, state):
    """``layer(x, mode, state)``, recomputed in the backward under
    ``cfg.remat`` while training (the reference's ``_remat`` of its Mamba2
    and mLSTM scan bodies)."""
    if mode == "train" and _remat(layer, cfg, None):
        return checkpoint(layer, x, mode, state, use_reentrant=False,
                          preserve_rng_state=False)
    return layer(x, mode, state)


def _stacked(states: list):
    """Per-layer state trees (dicts and tuples of tensors) stacked on a new
    leading axis; None if the layers returned none."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stacked([s[k] for s in states]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stacked([s[i] for s in states]) for i in range(len(first)))
    return torch.stack(states)


def _pick(tree, index):
    """The ``index`` slice of every leaf of a stacked state tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, index) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_pick(v, index) for v in tree)
    return tree[index]


def _write(dst, src) -> None:
    """Copy the state tree ``src`` into ``dst``'s tensors (a decode step's
    in-place update of its cache)."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _write(d, s)
    else:
        dst.copy_(src)


def _forward_zamba(model, cfg, tokens, mode, cache, cache_pos) -> ForwardOut:
    """The reference's ``_forward_zamba``: each group's Mamba2 layers, then
    the shared attention block with the group's own KV cache. Positions
    start at ``cache_pos`` in decode. A cache comes back when one was given
    or in prefill: prefill's states start from zero, even with a cache."""
    x = model.embed(tokens).to(dtype_of(cfg.compute_dtype))
    b, t, _ = x.shape
    decode = mode == "decode"
    positions = _positions(cfg, b, t, start=cache_pos if decode else 0, device=x.device)
    attn = None if cache is None else _stack_cache(cache["attn"], mode)
    states = []
    for g, group in enumerate(model.mamba):
        group_states = []
        for i, layer in enumerate(group):
            state = _pick(cache["mamba"], (g, i)) if decode else None
            x, new = _state_layer(layer, cfg, x, mode, state)
            if decode:
                _write(state, new)
            group_states.append(new)
        states.append(_stacked(group_states))
        if model.shared_attn is not None:
            acache = None if attn is None else {
                "self": {name: a[g] for name, a in attn["self"].items()}}
            x, _, _ = model.shared_attn(x, cfg, positions=positions, cache=acache,
                                        cache_pos=cache_pos)
    logits = _lm_head(model, cfg, x)
    new_cache = None
    if cache is not None or mode == "prefill":
        new_cache = {"mamba": cache["mamba"] if decode else _stacked(states),
                     "attn": attn if attn is not None else {}}
    return ForwardOut(logits=logits, cache=new_cache, stats=None)


def _forward_xlstm(model, cfg, tokens, mode, cache) -> ForwardOut:
    """The reference's ``_forward_xlstm``: each group's mLSTM layers, then
    its sLSTM. mLSTM states start from zero in prefill; the sLSTM runs from
    the cache's state whenever a cache is given (prefill or decode)."""
    x = model.embed(tokens).to(dtype_of(cfg.compute_dtype))
    decode = mode == "decode"
    m_states, s_states = [], []
    for g, (group, s_layer) in enumerate(zip(model.mlstm, model.slstm)):
        group_states = []
        for i, layer in enumerate(group):
            state = _pick(cache["mlstm"], (g, i)) if decode else None
            x, new = _state_layer(layer, cfg, x, mode, state)
            if decode:
                _write(state, new)
            group_states.append(new)
        m_states.append(_stacked(group_states))
        state = None if cache is None else _pick(cache["slstm"], g)
        x, new = s_layer(x, mode, state)
        if decode:
            _write(state, new)
        s_states.append(new)
    logits = _lm_head(model, cfg, x)
    new_cache = None
    if decode:
        new_cache = cache
    elif cache is not None or mode == "prefill":
        new_cache = {"mlstm": _stacked(m_states), "slstm": _stacked(s_states)}
    return ForwardOut(logits=logits, cache=new_cache, stats=None)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Token cross-entropy in float32: the mean over ``mask`` (default all)
    of ``logsumexp(logits) - logits[label]``. ``labels``: (B, T) ints."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = torch.as_tensor(mask, device=nll.device).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zeroed cache for ``batch`` sequences of up to ``max_len`` tokens, in
    the reference's layout, on ``device`` (default: the current CUDA device;
    without one this raises):

    * GQA: ``{"layers": {"self": {"k", "v"}}}``, each ``(layers, batch,
      max_len, n_kv, head_dim)``, and for an MoE config with leading dense
      layers a ``"dense"`` part of theirs;
    * MLA: the same parts of ``{"self": {"c_kv" (layers, batch, max_len,
      kv_lora), "k_pe" (..., qk_rope)}}``;
    * whisper: ``{"dec": {"self": {"k", "v"}}, "cross": (k, v)}``, the cross
      pair ``(layers, batch, enc_len, n_kv, head_dim)`` each;
    * zamba2: ``{"mamba": {"ssm", "conv"}, "attn": {"self": {"k", "v"}}}``,
      float32 states on ``(groups, attn_every, batch)`` and the shared
      block's keys and values ``(groups, batch, max_len, n_kv, head_dim)``;
    * xLSTM: ``{"mlstm": {"cell": (C, n, m), "conv"}, "slstm": (h, c, n,
      m)}``, float32 states on ``(groups, slstm_every - 1, batch)`` and
      ``(groups, batch)``, every ``m`` filled with -1e30.
    """
    check_supported(cfg)
    device = default_device(device, "init_cache")
    hd = cfg.resolved_head_dim()

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(layers: int) -> dict:
        if cfg.mla is not None:
            m = cfg.mla
            return {"self": {"c_kv": zeros(layers, batch, max_len, m.kv_lora),
                             "k_pe": zeros(layers, batch, max_len, m.qk_rope)}}
        return {"self": {"k": zeros(layers, batch, max_len, cfg.n_kv, hd),
                         "v": zeros(layers, batch, max_len, cfg.n_kv, hd)}}

    def states(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    if cfg.xlstm is not None:
        a = cfg.xlstm
        groups, per = _groups(cfg)
        lead = (groups, per - 1, batch, a.n_heads)
        s_shape = (groups, batch, a.n_heads, a.s_head_dim)
        return {"mlstm": {"cell": (states(*lead, a.head_dim, a.head_dim),
                                   states(*lead, a.head_dim), states(*lead, fill=X.M_INIT)),
                          "conv": states(groups, per - 1, batch, a.conv_kernel - 1, a.d_inner)},
                "slstm": (states(*s_shape), states(*s_shape), states(*s_shape),
                          states(*s_shape, fill=X.M_INIT))}
    if cfg.ssm is not None:
        a = cfg.ssm
        groups, per = _groups(cfg)
        out = {"mamba": {"ssm": states(groups, per, batch, a.n_heads, a.head_dim, a.d_state),
                         "conv": states(groups, per, batch, a.conv_kernel - 1, a.conv_dim)},
               "attn": None}
        if cfg.attn_every:
            out["attn"] = kv(groups)
        return out
    if cfg.enc_dec:
        cross = (cfg.n_layers, batch, cfg.enc_len, cfg.n_kv, hd)
        return {"dec": kv(cfg.n_layers), "cross": (zeros(*cross), zeros(*cross))}
    n_dense = _n_dense(cfg)
    out = {"layers": kv(cfg.n_layers - n_dense)}
    if n_dense:
        out["dense"] = kv(n_dense)
    return out
