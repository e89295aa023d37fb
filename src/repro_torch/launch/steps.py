"""The train step of the port (the reference's ``repro.launch.steps.
build_train_step``).

The reference's step is one jitted program over sharded parameters; here
it is a function that runs the forward and the backward on the model's
device and applies AdamW in place. The reference's sharding specs
(``param_specs``, ``opt_specs``, ``input_specs``) and its prefill and
decode steps are XLA-only: they wait for the multi-device slice
(ROADMAP item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig, Shape
from repro_torch.train.optim import OptConfig, adamw_step

__all__ = ["build_train_step"]


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
