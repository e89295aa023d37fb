"""The yardstick of the serving cells: the work a DeepSeek-V2 configuration
needs for the tokens it serves, counted from its numbers, and what the
serving readers share.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W (dense rates):
989 TFLOP/s in bfloat16 on the tensor cores, HBM at 3.35 TB/s
(``roofline.py``). Work is what the model's equations need, not what
the program happens to compute: a prefill the engine runs on every lane
counts once, attention is causal, and the head counts only where a
served token is chosen.
"""

from __future__ import annotations

import statistics
from typing import Optional

import numpy as np

from os4m_bench import roofline

BF16_OPS_PER_S = 989e12
BF16_BYTES = 2


def matmul_params(config: dict) -> dict:
    """Weights a token is multiplied by, per part: ``attn`` (one layer's
    MLA projections), ``dense`` (a dense layer's MLP), ``moe`` (a MoE layer's
    router, its ``num_experts_per_tok`` routed and its shared experts) and
    ``head``."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    nope, rope, vd = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    q_lora, kv_lora = config["q_lora_rank"], config["kv_lora_rank"]
    f = config["moe_intermediate_size"]
    attn = (d * q_lora + q_lora * h * (nope + rope) + d * (kv_lora + rope)
            + kv_lora * h * (nope + vd) + h * vd * d)
    experts = config["num_experts_per_tok"] + config["n_shared_experts"]
    return {"attn": attn, "dense": 3 * d * config["intermediate_size"],
            "moe": d * config["n_routed_experts"] + experts * 3 * d * f,
            "head": d * config["vocab_size"]}


def attention_ops(config: dict, queries: int, first: int = 0) -> float:
    """One layer's attention operations (scores and values, every head)
    for the queries at positions ``first .. first + queries - 1``, each
    over the keys up to and including its own."""
    h = config["num_attention_heads"]
    width = config["qk_nope_head_dim"] + config["qk_rope_head_dim"] + config["v_head_dim"]
    keys = queries * first + queries * (queries + 1) / 2
    return 2.0 * h * width * keys


def request_ops(config: dict, prompt: int, served: int) -> float:
    """Operations that serving one request needs: every prompt token and
    every served token but the last goes through the model once, and the
    head runs once a served token."""
    fed = prompt + max(served - 1, 0)
    p = matmul_params(config)
    layers = config["num_hidden_layers"]
    dense = config["first_k_dense_replace"]
    per_token = layers * p["attn"] + dense * p["dense"] + (layers - dense) * p["moe"]
    return (2.0 * fed * per_token + 2.0 * served * p["head"]
            + layers * attention_ops(config, fed))


def prefill_attention_work(config: dict, lanes: int, prompt: int) -> roofline.Work:
    """Kernel 9's work in one admission's prefill, one layer: ``lanes``
    rows of ``prompt`` tokens (the engine runs the prompt on every lane),
    causal; q and k of ``qk_nope + qk_rope`` dims, v and the output of
    ``v_head_dim``, each read or written once in bfloat16."""
    h = config["num_attention_heads"]
    dqk = config["qk_nope_head_dim"] + config["qk_rope_head_dim"]
    rows = lanes * h * prompt
    nbytes = rows * (2 * dqk + 2 * config["v_head_dim"]) * BF16_BYTES
    return roofline.Work(nbytes, lanes * attention_ops(config, prompt))


def bound_s(work: roofline.Work) -> float:
    """Least time of bfloat16 ``work``: bytes at the HBM rate or ops at the
    tensor cores' rate."""
    return max(work.nbytes / roofline.HBM_BYTES_PER_S, work.ops / BF16_OPS_PER_S)


def tokens_per_s(run) -> Optional[float]:
    """Served tokens of the window's requests over the window."""
    if not run.requests:
        return None
    return sum(len(r.output) for r in run.requests) / run.window_s


def tpot_ms(run) -> list:
    """Each request's time per output token after the first, in ms."""
    return [(r.token_s[-1] - r.token_s[0]) * 1e3 / (len(r.token_s) - 1)
            for r in run.requests if len(r.token_s) >= 2]


def tpot_ms_quantile(run, q: float) -> Optional[float]:
    """The ``q`` quantile (0-100, linear) of :func:`tpot_ms` over the window."""
    values = tpot_ms(run)
    return float(np.percentile(values, q)) if values else None


def median_ms(seconds: list) -> Optional[float]:
    return 1e3 * statistics.median(seconds) if seconds else None


def attention_roofline(run, *kernels: str) -> Optional[float]:
    """The least time of every prefill's attention in the window over the
    device time of the kernels named by ``kernels``, in %."""
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(*kernels)
    if seconds <= 0:
        return None
    lanes, layers = run.config["engine"]["lanes"], run.config["num_hidden_layers"]
    least = sum(layers * bound_s(prefill_attention_work(run.config, lanes, r.prompt.shape[0]))
                for r in run.requests if r.output)
    return 100.0 * least / seconds


def serve_mfu(run) -> Optional[float]:
    """Operations the window's served requests need over the window at the
    bfloat16 peak, in %."""
    if run.trace is None or not run.requests:
        return None
    ops = sum(request_ops(run.config, r.prompt.shape[0], len(r.output)) for r in run.requests)
    return 100.0 * ops / BF16_OPS_PER_S / run.window_s
