"""Load the reference's parameter values into the port's model.

The input is the reference's value tree (``repro.nn.layers.split(
repro.models.model.init_model(key, cfg))[0]``) with every leaf as a numpy
array, in nested dicts, the layer stacks' leaves carrying a leading layer
axis: ``values["layers"]`` (and ``"dense_layers"``), or whisper's
``values["enc"]`` and ``values["dec"]``; zamba2's ``values["mamba"]``
(leaves ``(groups, attn_every, ...)``) and its one ``"shared_attn"``
decoder layer (unstacked), xLSTM's ``values["mlstm"]`` ``(groups,
slstm_every - 1, ...)`` and ``values["slstm"]`` ``(groups, ...)``.
Attention is GQA (q, k, v, o with biases when the config has them) or MLA (its nine parameters); whisper's
decoder layers add ``ln_x`` and ``xattn``. Linear weights are ``(d_in, d_out)`` on
both sides, so every leaf copies as it is. numpy has no bfloat16: pass
float32 arrays (a bf16 reference leaf cast to float32 is exact); they are
cast to ``cfg.param_dtype`` here. Only numpy goes in, never a JAX object.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DecoderModel
from repro_torch.nn.attention import MLA

__all__ = ["params_from_reference"]


def _copy(dst: torch.Tensor, src, name: str) -> None:
    if not isinstance(src, np.ndarray):
        raise TypeError(f"{name}: expected a numpy array, got {type(src).__name__}")
    arr = src
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape} does not match {tuple(dst.shape)}")
    if arr.dtype.kind != "f":
        raise TypeError(f"{name}: expected floating-point values, got {arr.dtype}")
    dst.copy_(torch.from_numpy(np.array(arr, copy=True)).to(dst.dtype))


def _load_linear(lin, tree: Mapping, name: str, index=None) -> None:
    pick = (lambda a: a) if index is None else (lambda a: a[index])
    _copy(lin.w, pick(tree["w"]), f"{name}.w")
    if lin.b is not None:
        _copy(lin.b, pick(tree["b"]), f"{name}.b")
    elif "b" in tree:
        raise ValueError(f"{name}: the reference has a bias, the config has none")


def _load_norm(norm, tree: Mapping, name: str, index=None) -> None:
    pick = (lambda a: a) if index is None else (lambda a: a[index])
    _copy(norm.scale, pick(tree["scale"]), f"{name}.scale")
    if hasattr(norm, "bias"):
        _copy(norm.bias, pick(tree["bias"]), f"{name}.bias")


def _load_moe(moe, tree: Mapping, name: str, index: int) -> None:
    """An MoE layer: the router, the stacked ``(E, ...)`` expert weights in
    the reference's physical row order, and the shared experts."""
    _copy(moe.router, tree["router"]["w"][index], f"{name}.router.w")
    for part in ("up", "down", "gate"):
        w = getattr(moe, part)
        if w is None:
            if part in tree:
                raise ValueError(f"{name}: the reference is gated, the config not")
            continue
        _copy(w, tree[part]["w"][index], f"{name}.{part}.w")
    if moe.shared is not None:
        for part in ("up", "gate", "down"):
            _load_linear(moe.shared[part], tree["shared"][part], f"{name}.shared.{part}",
                         index)


_MLA_LINEARS = ("q_down", "q_up", "kv_down", "k_pe", "k_up", "v_up", "o")
_MLA_NORMS = ("q_norm", "kv_norm")


def _load_attention(attn, tree: Mapping, name: str, index: int) -> None:
    if isinstance(attn, MLA):
        for part in _MLA_LINEARS:
            _load_linear(getattr(attn, part), tree[part], f"{name}.{part}", index)
        for part in _MLA_NORMS:
            _load_norm(getattr(attn, part), tree[part], f"{name}.{part}", index)
        return
    for part in ("q", "k", "v", "o"):
        _load_linear(getattr(attn, part), tree[part], f"{name}.{part}", index)


def _load_layer(layer, tree: Mapping, pre: str, i) -> None:
    """A decoder layer from ``tree``'s leaves at ``i`` (a layer index of a
    stack, or None: zamba2's one shared block)."""
    _load_norm(layer.ln1, tree["ln1"], f"{pre}.ln1", i)
    _load_norm(layer.ln2, tree["ln2"], f"{pre}.ln2", i)
    _load_attention(layer.attn, tree["attn"], f"{pre}.attn", i)
    if layer.xattn is not None:
        _load_norm(layer.ln_x, tree["ln_x"], f"{pre}.ln_x", i)
        _load_attention(layer.xattn, tree["xattn"], f"{pre}.xattn", i)
    if layer.moe is not None:
        _load_moe(layer.moe, tree["moe"], f"{pre}.moe", i)
        return
    for part in ("up", "down", "gate"):
        lin = getattr(layer.mlp, part)
        if lin is None:
            if part in tree["mlp"]:
                raise ValueError(f"{pre}.mlp: the reference is gated, the config not")
            continue
        _load_linear(lin, tree["mlp"][part], f"{pre}.mlp.{part}", i)


def _load_stack(layers, stack: Mapping, name: str) -> None:
    for i, layer in enumerate(layers):
        _load_layer(layer, stack, f"{name}[{i}]", i)


def _load_by_name(module, tree: Mapping, pre: str, index) -> None:
    """Every parameter of ``module`` (a Mamba2, mLSTM or sLSTM layer, whose
    parameter names are the reference's paths: ``mixer.in_proj.w`` is
    ``tree["mixer"]["in_proj"]["w"]``) from its stacked leaf at ``index``."""
    for name, param in module.named_parameters():
        leaf = tree
        for key in name.split("."):
            leaf = leaf[key]
        _copy(param, leaf[index], f"{pre}.{name}")


def params_from_reference(values: Mapping, cfg: ModelConfig, device=None,
                          ep_slots: int = 1) -> DecoderModel:
    """The port's model of ``cfg`` on ``device`` (default: the current CUDA
    device; without one this raises) holding the reference's values, MoE
    layers over ``ep_slots`` stacked expert slots."""
    model = DecoderModel(cfg, device=device, ep_slots=ep_slots)
    with torch.no_grad():
        _copy(model.embed.w, values["embed"]["w"], "embed.w")
        _load_norm(model.final_norm, values["final_norm"], "final_norm")
        _load_linear(model.lm_head, values["lm_head"], "lm_head")
        if cfg.xlstm is not None:
            for g, (group, s_layer) in enumerate(zip(model.mlstm, model.slstm)):
                for i, layer in enumerate(group):
                    _load_by_name(layer, values["mlstm"], f"mlstm[{g}][{i}]", (g, i))
                _load_by_name(s_layer, values["slstm"], f"slstm[{g}]", g)
            return model
        if cfg.ssm is not None:
            for g, group in enumerate(model.mamba):
                for i, layer in enumerate(group):
                    _load_by_name(layer, values["mamba"], f"mamba[{g}][{i}]", (g, i))
            if model.shared_attn is not None:
                _load_layer(model.shared_attn, values["shared_attn"], "shared_attn", None)
            return model
        if cfg.enc_dec:
            _load_stack(model.enc_layers, values["enc"], "enc")
            _load_norm(model.enc_norm, values["enc_norm"], "enc_norm")
            _load_stack(model.layers, values["dec"], "dec")
            return model
        if len(model.dense_layers):
            _load_stack(model.dense_layers, values["dense_layers"], "dense_layers")
        _load_stack(model.layers, values["layers"], "layers")
    return model
