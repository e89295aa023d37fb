"""The weights of a DeepSeek-V2 configuration, drawn from the seed, and how
each side takes them.

Every tensor is named as in the published checkpoint
(``model.layers.{i}.self_attn.q_a_proj.weight``, ...) and drawn on its own
``torch.Generator``, seeded from ``--seed`` and its name, in one call: the
same seed gives the same bits on the same device, whatever is drawn
before it. So the program gets its weights at set-up (:func:`fill_program`,
straight into the port's tensors) and the reference draws them again
once the program is freed (:func:`reference_tensors`), and neither takes
anything from the other. Matrices are stored ``(d_in, d_out)`` and apply
as ``x @ w`` (the checkpoint stores ``(d_out, d_in)``); the experts of a
layer are stacked ``(E, d_in, d_out)``; ``kv_b_proj``'s columns are per
head ``[k_nope | v]``, as the checkpoint's rows are.

Draws are in the served type (``port.param_dtype``; the router in
float32): matrices normal times ``d_in ** -0.5``, and those that write
into the residual stream (``o_proj`` and every ``down_proj``) times
``(2 * layers) ** -0.5`` more (GPT-2's scaled initialisation, at the depth
run); the embedding standard normal; norm scales normal(1, 0.1). So a
token's own embedding leads its hidden state and tokens route by what
they are. With the embedding at ``d ** -0.5`` and no scaling, attention's
average over the prompt leads every position's hidden state alike, and
nearly every token went to one expert (26x its share; PERF.md, Cells).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# float8_e4m3fn's largest finite value.
FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Spec:
    """One tensor: its shape, type, and the normal it is drawn from."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    mean: float
    std: float


def tensor_seed(seed: int, name: str) -> int:
    """The generator seed of tensor ``name`` under ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def is_dense(config: dict, layer: int) -> bool:
    return layer < int(config["first_k_dense_replace"])


def _matrix(shape, dtype, scale: float = 1.0) -> Spec:
    return Spec(tuple(shape), dtype, 0.0, scale * shape[-2] ** -0.5)


def _residual_scale(config: dict) -> float:
    """The scale of the matrices that write into the residual stream:
    ``(2 * layers) ** -0.5``, GPT-2's over its residual layers (attention
    and MLP of each layer), at the depth the configuration runs."""
    return (2 * int(config["num_hidden_layers"])) ** -0.5


def _norm(width: int, dtype) -> Spec:
    return Spec((width,), dtype, 1.0, 0.1)


def layer_specs(config: dict, layer: int) -> Dict[str, Spec]:
    """The tensors of decoder layer ``layer``, by their checkpoint names."""
    dt = _DTYPES[config["port"]["param_dtype"]]
    d, h = config["hidden_size"], config["num_attention_heads"]
    nope, rope = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    vd, q_lora, kv_lora = config["v_head_dim"], config["q_lora_rank"], config["kv_lora_rank"]
    p = f"model.layers.{layer}."
    res = _residual_scale(config)
    out = {
        p + "input_layernorm.weight": _norm(d, dt),
        p + "self_attn.q_a_proj.weight": _matrix((d, q_lora), dt),
        p + "self_attn.q_a_layernorm.weight": _norm(q_lora, dt),
        p + "self_attn.q_b_proj.weight": _matrix((q_lora, h * (nope + rope)), dt),
        p + "self_attn.kv_a_proj_with_mqa.weight": _matrix((d, kv_lora + rope), dt),
        p + "self_attn.kv_a_layernorm.weight": _norm(kv_lora, dt),
        p + "self_attn.kv_b_proj.weight": _matrix((kv_lora, h * (nope + vd)), dt),
        p + "self_attn.o_proj.weight": _matrix((h * vd, d), dt, res),
        p + "post_attention_layernorm.weight": _norm(d, dt),
    }
    if is_dense(config, layer):
        f = config["intermediate_size"]
        out.update({p + "mlp.gate_proj.weight": _matrix((d, f), dt),
                    p + "mlp.up_proj.weight": _matrix((d, f), dt),
                    p + "mlp.down_proj.weight": _matrix((f, d), dt, res)})
    else:
        e, f = config["n_routed_experts"], config["moe_intermediate_size"]
        fs = config["n_shared_experts"] * f
        out.update({p + "mlp.gate.weight": _matrix((d, e), torch.float32),
                    p + "mlp.experts.gate_proj.weight": _matrix((e, d, f), dt),
                    p + "mlp.experts.up_proj.weight": _matrix((e, d, f), dt),
                    p + "mlp.experts.down_proj.weight": _matrix((e, f, d), dt, res),
                    p + "mlp.shared_experts.gate_proj.weight": _matrix((d, fs), dt),
                    p + "mlp.shared_experts.up_proj.weight": _matrix((d, fs), dt),
                    p + "mlp.shared_experts.down_proj.weight": _matrix((fs, d), dt, res)})
    return out


def outer_specs(config: dict) -> Dict[str, Spec]:
    """The embedding, the final norm and the head."""
    dt = _DTYPES[config["port"]["param_dtype"]]
    d, v = config["hidden_size"], config["vocab_size"]
    return {"model.embed_tokens.weight": Spec((v, d), dt, 0.0, 1.0),
            "model.norm.weight": _norm(d, dt),
            "lm_head.weight": _matrix((d, v), dt)}


def draw(name: str, spec: Spec, seed: int, device, out: torch.Tensor = None) -> torch.Tensor:
    """Tensor ``name`` under ``seed``, drawn into ``out`` (or a new tensor)."""
    if out is None:
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    if tuple(out.shape) != spec.shape or out.dtype != spec.dtype:
        raise ValueError(f"{name}: {tuple(out.shape)} {out.dtype} is not {spec}")
    gen = torch.Generator(device=out.device)
    gen.manual_seed(tensor_seed(seed, name))
    return out.normal_(spec.mean, spec.std, generator=gen)


def _program_layer_targets(layer, config: dict, prefix: str) -> dict:
    """Checkpoint name -> ``[(port tensor, view of the draw)]`` of one layer."""
    a = layer.attn
    h, kv_lora = config["num_attention_heads"], config["kv_lora_rank"]
    nope = config["qk_nope_head_dim"]
    whole = lambda w: w                                            # noqa: E731
    kv_b = lambda w: w.view(kv_lora, h, -1)                        # noqa: E731
    targets = {
        "input_layernorm.weight": [(layer.ln1.scale, whole)],
        "self_attn.q_a_proj.weight": [(a.q_down.w, whole)],
        "self_attn.q_a_layernorm.weight": [(a.q_norm.scale, whole)],
        "self_attn.q_b_proj.weight": [(a.q_up.w, whole)],
        "self_attn.kv_a_proj_with_mqa.weight": [
            (a.kv_down.w, lambda w: w[:, :kv_lora]), (a.k_pe.w, lambda w: w[:, kv_lora:])],
        "self_attn.kv_a_layernorm.weight": [(a.kv_norm.scale, whole)],
        "self_attn.kv_b_proj.weight": [
            (a.k_up.w, lambda w: kv_b(w)[..., :nope].reshape(kv_lora, -1)),
            (a.v_up.w, lambda w: kv_b(w)[..., nope:].reshape(kv_lora, -1))],
        "self_attn.o_proj.weight": [(a.o.w, whole)],
        "post_attention_layernorm.weight": [(layer.ln2.scale, whole)],
    }
    if layer.mlp is not None:
        for n in ("gate", "up", "down"):
            targets[f"mlp.{n}_proj.weight"] = [(getattr(layer.mlp, n).w, whole)]
    else:
        m = layer.moe
        targets["mlp.gate.weight"] = [(m.router, whole)]
        for n in ("gate", "up", "down"):
            targets[f"mlp.experts.{n}_proj.weight"] = [(getattr(m, n), whole)]
            targets[f"mlp.shared_experts.{n}_proj.weight"] = [(m.shared[n].w, whole)]
    return {prefix + k: v for k, v in targets.items()}


def fill_program(model, config: dict, seed: int) -> int:
    """Draw every weight of ``config`` under ``seed`` into the port's
    ``DecoderModel`` ``model`` (its experts stacked in id order, as the
    default placement holds them). A tensor the port keeps whole is drawn
    in place; one it splits is drawn once and copied. Raises unless every
    element of the model is written exactly once. Returns the elements."""
    layers = list(model.dense_layers) + list(model.layers)
    targets = {"model.embed_tokens.weight": [(model.embed.w, lambda w: w)],
               "model.norm.weight": [(model.final_norm.scale, lambda w: w)],
               "lm_head.weight": [(model.lm_head.w, lambda w: w)]}
    specs = dict(outer_specs(config))
    for i, layer in enumerate(layers):
        targets.update(_program_layer_targets(layer, config, f"model.layers.{i}."))
        specs.update(layer_specs(config, i))
    if set(targets) != set(specs):
        raise ValueError(f"the port's model and the configuration differ: "
                         f"{sorted(set(targets) ^ set(specs))}")
    written = {}
    for name, spec in specs.items():
        pieces = targets[name]
        if len(pieces) == 1 and pieces[0][0].shape == spec.shape:
            draw(name, spec, seed, None, out=pieces[0][0].data)
        else:
            full = draw(name, spec, seed, pieces[0][0].device)
            for param, view in pieces:
                param.data.copy_(view(full))
            del full
        for param, _ in pieces:
            written[id(param)] = written.get(id(param), 0) + 1
    params = list(model.parameters())
    if len(params) != len(written) or any(written.get(id(p)) != 1 for p in params):
        raise ValueError("fill_program: some weight of the port was not written exactly once")
    return sum(p.numel() for p in params)


def reference_tensors(specs: Dict[str, Spec], seed: int, device,
                      fp8: bool = False) -> Dict[str, torch.Tensor]:
    """``specs``' tensors drawn again under ``seed``, in float32. With
    ``fp8`` every matrix is first rounded through ``float8_e4m3fn`` with one
    scale a matrix (each expert's its own): the lower-precision control."""
    out = {}
    for name, spec in specs.items():
        w = draw(name, spec, seed, device).float()
        if fp8 and len(spec.shape) > 1 and not name.endswith("mlp.gate.weight"):
            w = fp8_round(w)
        out[name] = w
    return out


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` (float32) through ``float8_e4m3fn`` and back, scaled so that
    each matrix's (or each expert's) largest entry maps to 448."""
    dims = tuple(range(w.dim() - 2, w.dim()))
    scale = w.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

