"""Step builders and input specs for training and serving (the reference's
``repro.launch.steps``) on one card.

``build_train_step`` returns a function that runs the forward and the
backward on the model's device and applies AdamW in place (the
reference's step is one jitted program over sharded parameters).
``build_prefill_step`` / ``build_decode_step`` / ``build_step_for_shape``
return ``(step_fn, example_args)`` as the reference's do, with the example
arguments built on PyTorch's ``meta`` device: every parameter, optimizer
moment, cache leaf and input has its real shape and dtype and no storage,
so ``step_fn(*example_args)`` runs the whole step without allocating
anything (the dry-run, :mod:`repro_torch.launch.dryrun`). The reference's
``NamedSharding``s have no counterpart: one card holds every tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig, Shape
from repro_torch.train.optim import OptConfig, adamw_step, init_opt

__all__ = ["param_specs", "opt_specs", "cache_specs", "input_specs", "build_train_step",
           "build_prefill_step", "build_decode_step", "build_step_for_shape"]

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Shapes and dtypes on the meta device (no allocation)
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> MDL.DecoderModel:
    """The model with every weight on ``meta``: its real shapes and dtypes,
    no storage (``named_parameters()`` are the specs)."""
    return MDL.DecoderModel(cfg, device=META)


def opt_specs(params: Dict[str, torch.Tensor], opt_cfg: OptConfig) -> dict:
    """AdamW's state for ``params`` on ``meta``. The step counter is a host
    scalar: the update reads it on the host (the bias corrections)."""
    state = init_opt(params, opt_cfg)
    state["step"] = torch.zeros((), dtype=torch.int32)
    return state


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> dict:
    """The serving cache of ``batch`` sequences of ``max_len`` on ``meta``."""
    return MDL.init_cache(cfg, batch, max_len, dtype, device=META)


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, Any]:
    """Every model input of ``shape`` on ``meta``: the tokens (the text part
    of a vlm's sequence), a vlm's patch embeddings or whisper's frames (bf16,
    as the reference's), one token a lane for a decode."""
    b = shape.global_batch
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = torch.empty((b, shape.seq_len - (cfg.n_patches or 0)),
                                    dtype=torch.int32, device=META)
        if cfg.n_patches:
            out["extra_embed"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                             dtype=torch.bfloat16, device=META)
        if cfg.enc_dec:
            out["extra_embed"] = torch.empty((b, cfg.enc_len, cfg.d_model),
                                             dtype=torch.bfloat16, device=META)
    else:
        out["tokens"] = torch.empty((b, 1), dtype=torch.int32, device=META)
    return out


def build_train_step(cfg: ModelConfig, shape: Shape, opt_cfg: OptConfig = OptConfig(), *,
                     ep_slots: int = 1, max_load_ratio: float = 1.0, microbatches: int = 1,
                     moe_pipeline_chunks: Optional[int] = None):
    """Returns ``train_step(model, opt_state, batch, placements) -> (model,
    opt_state, metrics)``; the model's weights and ``opt_state`` are
    updated in place.

    The loss is ``lm_loss(logits[:, n_patches:-1], tokens[:, 1:]) +
    aux_loss``. ``microbatches > 1`` splits the global batch, accumulates
    float32 gradients over the pieces and divides, and (as the reference)
    returns no ``expert_counts``. ``moe_pipeline_chunks`` overrides the MoE
    layers' ``pipeline_chunks``. The MoE capacity is
    ``moe_capacity_for_shape`` of a microbatch over ``ep_slots`` expert
    slots (the reference's model axis). Metrics: ``loss``,
    ``total_loss``, ``grad_norm``, ``lr``, and for an MoE config
    ``expert_counts`` (L_moe, E) and ``overflow``, as device tensors.
    """
    if moe_pipeline_chunks is not None and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, pipeline_chunks=int(moe_pipeline_chunks)))
    mb_batch = shape.global_batch // max(microbatches, 1)
    moe_cap = MDL.moe_capacity_for_shape(cfg, mb_batch, shape.seq_len, ep_slots,
                                         max_load_ratio)

    def loss_for(model, tokens, extra, placements):
        out = MDL.forward(model, cfg, tokens=tokens, extra_embed=extra, mode="train",
                          placements=placements, moe_capacity=moe_cap)
        npch = cfg.n_patches or 0
        loss = MDL.lm_loss(out.logits[:, npch:-1], tokens[:, 1:])
        stats = dict(out.stats or {})
        aux = stats.get("aux_loss", 0.0)
        return loss + aux, loss, stats

    def train_step(model, opt_state, batch, placements):
        params = {k: p for k, p in model.named_parameters() if p.requires_grad}
        tokens, extra = batch["tokens"], batch.get("extra_embed")
        if microbatches <= 1:
            total, loss, extras = loss_for(model, tokens, extra, placements)
            grads = torch.autograd.grad(total, list(params.values()))
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in params.values()]
            total = loss = 0.0
            for i in range(microbatches):
                rows = slice(i * mb_batch, (i + 1) * mb_batch)
                tot_i, loss_i, _ = loss_for(model, tokens[rows],
                                            None if extra is None else extra[rows],
                                            placements)
                for acc, g in zip(grads, torch.autograd.grad(tot_i, list(params.values()))):
                    acc += g.float()
                total, loss = total + tot_i.detach(), loss + loss_i.detach()
            grads = [g / microbatches for g in grads]
            total, loss = total / microbatches, loss / microbatches
            extras = {}
        _, opt_state, om = adamw_step(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss.detach(), "total_loss": total.detach(), **om}
        if "expert_counts" in extras:
            metrics["expert_counts"] = extras["expert_counts"].detach()
            metrics["overflow"] = extras["overflow"]
        return model, opt_state, metrics

    return train_step


def _train_example(cfg: ModelConfig, shape: Shape, opt_cfg: OptConfig):
    model = param_specs(cfg).requires_grad_(True)
    params = {k: p for k, p in model.named_parameters()}
    placements = MDL.default_placements(cfg, 1, device=META)
    return model, opt_specs(params, opt_cfg), input_specs(cfg, shape), placements


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, shape: Shape, cache_dtype=torch.bfloat16, *,
                       max_len: Optional[int] = None):
    """Prefill: run the prompt, return ``(last-token logits, filled cache)``.

    Returns ``(prefill_step, (model, batch, cache))`` with the example
    arguments on ``meta``; the cache holds ``max_len`` positions (default
    ``shape.seq_len``).
    """
    moe_cap = MDL.moe_capacity_for_shape(cfg, shape.global_batch, shape.seq_len, 1)

    def prefill_step(model, batch, cache):
        with torch.inference_mode():            # as the serving engine runs
            out = MDL.forward(model, cfg, tokens=batch["tokens"],
                              extra_embed=batch.get("extra_embed"), mode="prefill",
                              cache=cache, cache_pos=0, moe_capacity=moe_cap)
            return out.logits[:, -1:], out.cache

    cache = cache_specs(cfg, shape.global_batch, max_len or shape.seq_len, cache_dtype)
    return prefill_step, (param_specs(cfg), input_specs(cfg, shape), cache)


def build_decode_step(cfg: ModelConfig, shape: Shape, cache_dtype=torch.bfloat16):
    """One new token a lane against a cache of ``shape.seq_len`` positions.

    Returns ``(decode_step, (model, cache, batch, pos))`` on ``meta``, with
    ``pos`` the last position of every lane; the decode writes its step
    into the cache in place, as the engine's does.
    """
    moe_cap = MDL.moe_capacity_for_shape(cfg, shape.global_batch, 1, 1)

    def decode_step(model, cache, batch, pos):
        with torch.inference_mode():
            out = MDL.forward(model, cfg, tokens=batch["tokens"], mode="decode", cache=cache,
                              cache_pos=pos, moe_capacity=moe_cap)
            return out.logits, out.cache

    cache = cache_specs(cfg, shape.global_batch, shape.seq_len, cache_dtype)
    # One position a lane, as the engine's decode passes them (a scalar
    # position would be read on the host).
    pos = torch.full((shape.global_batch,), shape.seq_len - 1, dtype=torch.int32, device=META)
    return decode_step, (param_specs(cfg), cache, input_specs(cfg, shape), pos)


def build_step_for_shape(cfg: ModelConfig, shape: Shape, *, opt_cfg: OptConfig = OptConfig(),
                         microbatches: int = 1, cache_dtype=torch.bfloat16,
                         max_len: Optional[int] = None):
    """``(step_fn, example_args)`` of ``shape``'s kind, the example on ``meta``
    (an MoE config's experts on one expert slot)."""
    if shape.kind == "train":
        step = build_train_step(cfg, shape, opt_cfg, microbatches=microbatches)
        return step, _train_example(cfg, shape, opt_cfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, cache_dtype, max_len=max_len)
    return build_decode_step(cfg, shape, cache_dtype)
