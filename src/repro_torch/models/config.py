"""Architecture + input-shape configuration.

``ModelConfig`` is a frozen (hashable) dataclass, field for field the
reference's (``repro.models.config``), so that a configuration carries
across the two packages unchanged. One config file per assigned
architecture lives in ``repro_torch/configs/``; the four assigned input
shapes are global (``SHAPES``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.nn.moe import MoEArgs
from repro_torch.nn.ssm import SSMArgs
from repro_torch.nn.xlstm import XLSTMArgs

__all__ = ["MLAArgs", "ModelConfig", "Shape", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class MLAArgs:
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "silu"
    gated_mlp: bool = True
    rope_kind: str = "rope"       # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    abs_pos: bool = False         # sinusoidal absolute positions (whisper)
    tie_embeddings: bool = False

    # MoE
    moe: Optional[MoEArgs] = None
    first_k_dense: int = 0        # leading dense layers (deepseek-v2: 1)
    first_dense_ff: int = 0       # d_ff of those dense layers

    # MLA (deepseek-v2)
    mla: Optional[MLAArgs] = None

    # Encoder-decoder (whisper): n_layers = decoder depth
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500           # precomputed frame embeddings (stub frontend)

    # VLM stub frontend: patch embeddings prepended to the text stream
    n_patches: int = 0
    patch_grid: int = 16

    # SSM / hybrid / xlstm
    ssm: Optional[SSMArgs] = None
    attn_every: int = 0           # zamba2: shared attn block every k ssm layers
    xlstm: Optional[XLSTMArgs] = None
    slstm_every: int = 0          # xlstm: 1 sLSTM per k layers

    # parallelism: "tp" = TP/SP over the model axis + FSDP over data (the
    # default); "fsdp" = batch + weights sharded over ALL axes, no tensor
    # parallelism (weight-gather instead of activation-gather — wins for
    # dense archs at large per-chip token counts; §Perf iteration).
    parallelism: str = "tp"

    # numerics / implementation
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_impl: str = "blocked"    # blocked | pallas | naive
    attn_block_q: int = 512
    attn_block_k: int = 1024
    remat: bool = True
    logit_dtype: str = "float32"

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D roofline bookkeeping)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.resolved_head_dim()
        n = V * d  # embeddings (untied lm head adds V*d below)
        n += V * d
        if self.xlstm is not None:
            a = self.xlstm
            per_m = (2 * d * a.d_inner + a.conv_kernel * a.d_inner
                     + 3 * a.n_heads * a.head_dim * a.head_dim
                     + 2 * a.d_inner * a.n_heads + a.d_inner * d)
            per_s = 4 * d * d + a.n_heads * a.s_head_dim * 4 * a.s_head_dim \
                + 3 * d * a.d_ffn
            n_s = L // max(self.slstm_every, 1) if self.slstm_every else 0
            return n + (L - n_s) * per_m + n_s * per_s
        if self.ssm is not None:
            a = self.ssm
            d_in_proj = 2 * a.d_inner + 2 * a.n_groups * a.d_state + a.n_heads
            per = d * d_in_proj + a.conv_kernel * a.conv_dim + a.d_inner * d
            n += L * per
            if self.attn_every:
                napp = 1  # weights shared across applications
                attn = d * (self.n_heads + 2 * self.n_kv) * hd \
                    + self.n_heads * hd * d
                mlp = 3 * d * self.d_ff
                n += napp * (attn + mlp)
            return n
        # attention
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora + m.q_lora * self.n_heads * (m.qk_nope + m.qk_rope)
                    + d * m.kv_lora + d * m.qk_rope
                    + m.kv_lora * self.n_heads * (m.qk_nope + m.v_dim)
                    + self.n_heads * m.v_dim * d)
        else:
            attn = d * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * d
        # mlp / moe
        if self.moe is not None:
            e = self.moe
            mults = 3 if e.gated else 2
            per_moe = e.num_experts * mults * d * e.d_ff + d * e.num_experts
            per_moe += 3 * d * e.shared_experts * e.d_ff
            n_dense = self.first_k_dense
            dense_ff = self.first_dense_ff or self.d_ff
            n += (L - n_dense) * (attn + per_moe)
            n += n_dense * (attn + (3 if self.gated_mlp else 2) * d * dense_ff)
        else:
            mults = 3 if self.gated_mlp else 2
            n += L * (attn + mults * d * self.d_ff)
            if self.enc_dec:
                # encoder layers + decoder cross-attn
                n += self.n_enc_layers * (attn + mults * d * self.d_ff)
                n += L * (d * (self.n_heads + 2 * self.n_kv) * hd
                          + self.n_heads * hd * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        total = self.param_count()
        mults = 3 if e.gated else 2
        all_exp = (self.n_layers - self.first_k_dense) * e.num_experts * mults \
            * self.d_model * e.d_ff
        act_exp = (self.n_layers - self.first_k_dense) * e.top_k * mults \
            * self.d_model * e.d_ff
        return total - all_exp + act_exp


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> Tuple[bool, str]:
    """DESIGN.md §5: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k skipped: pure full-attention architecture "
            "(a 500k dense KV cache is outside the arch's regime)"
        )
    return True, ""
