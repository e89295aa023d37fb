"""The plain reference of a DeepSeek-V2 decoder: the full forward pass of
each sequence in float32, in plain PyTorch, with no kernel, cache or
batching of the program. It imports nothing of the program and takes its
weights from ``dsv2_weights`` (drawn again from the seed).

The architecture (arXiv:2405.04434; the configuration's numbers):

* the token embedding;
* each layer: RMSNorm, multi-head latent attention, residual; RMSNorm, a
  SwiGLU MLP (the first ``first_k_dense_replace`` layers) or the MoE,
  residual; then the final RMSNorm and the head;
* attention: q through a LoRA (``q_a_proj``, RMSNorm, ``q_b_proj``) into
  per-head ``qk_nope + qk_rope`` dims; the compressed ``c_kv`` (RMSNorm of
  ``kv_a_proj_with_mqa``'s first ``kv_lora_rank`` columns) and one rotary
  key ``k_pe`` (its last ``qk_rope`` columns) shared by the heads;
  ``kv_b_proj`` gives each head's ``k_nope`` and ``v``; causal softmax
  over ``q_nope . k_nope + q_pe . k_pe``; ``o_proj`` over the heads' ``v``;
* the MoE: a softmax router over ``n_routed_experts``, the top
  ``num_experts_per_tok`` experts a token, each a SwiGLU of width
  ``moe_intermediate_size``, plus ``n_shared_experts`` always-on experts
  (one SwiGLU of their summed width).

Where the port departs from the published model, the reference follows
the port, so that a difference is the program's arithmetic and not a
choice the program does not offer (the configuration's ``departures``):

* routing keeps the top 6 of all 160 experts and renormalises the kept
  probabilities to sum 1; the published model takes them from the best 3
  of 8 expert groups (``group_limited_greedy``), keeps them unnormalised
  and scales the routed output by ``routed_scaling_factor``;
* RoPE rotates split halves at ``rope_theta`` with the softmax scale
  ``(qk_nope + qk_rope) ** -0.5``; the published model rotates
  interleaved pairs under YaRN (``rope_scaling``: factor 40, mscale).

Attention runs a block of query rows at a time and the MLPs a block of
tokens at a time, so that the reference fits beside nothing else on the
card; the blocks do not change the result beyond float rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from os4m_bench import dsv2_weights as W

ROW_BLOCK = 512          # query rows of attention at a time
TOKEN_BLOCK = 4096       # tokens of an MLP or the MoE at a time


def exact_float32() -> None:
    """Matrix products in float32, never in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x (T, ..., D)`` at positions ``0 .. T-1``,
    rotating split halves (the port's layout; see the module's notes)."""
    t, d = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    shape = (t,) + (1,) * (x.dim() - 2) + (d // 2,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, gate, up, down) -> torch.Tensor:
    return (F.silu(x @ gate) * (x @ up)) @ down


def attention(config: dict, w: Dict[str, torch.Tensor], p: str, x: torch.Tensor,
              row_block: int = ROW_BLOCK) -> torch.Tensor:
    """Causal multi-head latent attention of one sequence ``x (T, d)``."""
    t = x.shape[0]
    h, nope = config["num_attention_heads"], config["qk_nope_head_dim"]
    rope_d, vd = config["qk_rope_head_dim"], config["v_head_dim"]
    kv_lora, eps = config["kv_lora_rank"], config["rms_norm_eps"]
    theta = float(config["rope_theta"])
    a = p + "self_attn."
    q = rms_norm(x @ w[a + "q_a_proj.weight"], w[a + "q_a_layernorm.weight"], eps)
    q = (q @ w[a + "q_b_proj.weight"]).view(t, h, nope + rope_d)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], theta)
    kv = x @ w[a + "kv_a_proj_with_mqa.weight"]
    c_kv = rms_norm(kv[:, :kv_lora], w[a + "kv_a_layernorm.weight"], eps)
    k_pe = rope(kv[:, kv_lora:], theta)                              # (T, rope)
    kv_b = (c_kv @ w[a + "kv_b_proj.weight"]).view(t, h, nope + vd)
    k_nope, v = kv_b[..., :nope], kv_b[..., nope:]
    scale = (nope + rope_d) ** -0.5
    out = torch.empty((t, h, vd), dtype=x.dtype, device=x.device)
    for r0 in range(0, t, row_block):
        r1 = min(t, r0 + row_block)
        s = (torch.einsum("rhn,khn->hrk", q_nope[r0:r1], k_nope[:r1])
             + torch.einsum("rhe,ke->hrk", q_pe[r0:r1], k_pe[:r1])) * scale
        rows = torch.arange(r0, r1, device=x.device)[:, None]
        s = s.masked_fill(torch.arange(r1, device=x.device)[None, :] > rows, float("-inf"))
        out[r0:r1] = torch.einsum("hrk,khv->rhv", torch.softmax(s, dim=-1), v[:r1])
    return out.reshape(t, h * vd) @ w[a + "o_proj.weight"]


def moe(config: dict, w: Dict[str, torch.Tensor], p: str, x: torch.Tensor) -> torch.Tensor:
    """The MoE of tokens ``x (N, d)``: the routed experts and the shared ones."""
    m = p + "mlp."
    k = config["num_experts_per_tok"]
    probs = torch.softmax(x @ w[m + "gate.weight"], dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)          # the port's renormalisation
    y = swiglu(x, w[m + "shared_experts.gate_proj.weight"], w[m + "shared_experts.up_proj.weight"],
               w[m + "shared_experts.down_proj.weight"])
    gate, up, down = (w[m + f"experts.{n}_proj.weight"] for n in ("gate", "up", "down"))
    for e in torch.unique(top_e).tolist():
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        out = swiglu(x[tok], gate[e], up[e], down[e]) * top_p[tok, slot, None]
        y.index_add_(0, tok, out)
    return y


def mlp(config: dict, w: Dict[str, torch.Tensor], p: str, x: torch.Tensor,
        token_block: int = TOKEN_BLOCK) -> torch.Tensor:
    """The layer's MLP (dense or MoE) over ``x (N, d)``, a block of tokens at a time."""
    dense = W.is_dense(config, int(p.split(".")[2]))
    m = p + "mlp."
    out = []
    for r0 in range(0, x.shape[0], token_block):
        xb = x[r0:r0 + token_block]
        if dense:
            out.append(swiglu(xb, w[m + "gate_proj.weight"], w[m + "up_proj.weight"],
                              w[m + "down_proj.weight"]))
        else:
            out.append(moe(config, w, p, xb))
    return torch.cat(out)


def logits(config: dict, weights: Callable[[Dict[str, W.Spec]], Dict[str, torch.Tensor]],
           sequences: Sequence[torch.Tensor], starts: Sequence[int], device,
           row_block: int = ROW_BLOCK, token_block: int = TOKEN_BLOCK) -> List[torch.Tensor]:
    """Float32 logits of each sequence of ids ``sequences[i] (T_i,)`` at its
    positions ``starts[i] .. T_i - 1``: ``[(T_i - starts[i], vocab)]``.

    ``weights(specs)`` returns float32 tensors by name
    (``dsv2_weights.reference_tensors``); it is called once for the
    embedding, once a layer and once for the head, so that one layer's
    weights are held at a time. Every sequence runs the whole forward
    pass from position 0."""
    eps = config["rms_norm_eps"]
    outer = W.outer_specs(config)
    emb = weights({"model.embed_tokens.weight": outer["model.embed_tokens.weight"]})
    hs = [emb["model.embed_tokens.weight"][s.to(device).long()] for s in sequences]
    del emb
    for i in range(int(config["num_hidden_layers"])):
        w = weights(W.layer_specs(config, i))
        p = f"model.layers.{i}."
        hs = [h + attention(config, w, p, rms_norm(h, w[p + "input_layernorm.weight"], eps),
                            row_block) for h in hs]
        sizes = [h.shape[0] for h in hs]
        flat = torch.cat(hs)
        flat = flat + mlp(config, w, p, rms_norm(flat, w[p + "post_attention_layernorm.weight"],
                                                 eps), token_block)
        hs = list(torch.split(flat, sizes))
        del w, flat
    head = weights({k: outer[k] for k in ("model.norm.weight", "lm_head.weight")})
    return [rms_norm(h[s:], head["model.norm.weight"], eps) @ head["lm_head.weight"]
            for h, s in zip(hs, starts)]
