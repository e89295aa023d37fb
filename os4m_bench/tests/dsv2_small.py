"""Small DeepSeek-V2 configurations for the CPU tests: the serving cell's
configuration with the widths of the port's ``SMOKE`` preset
(``repro_torch/configs/deepseek_v2_236b.py``)."""

import dataclasses

from os4m_bench import spec

SMOKE = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
         "q_lora_rank": 24, "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 4,
         "v_head_dim": 8, "n_routed_experts": 8, "num_experts_per_tok": 2,
         "n_shared_experts": 1, "moe_intermediate_size": 48, "intermediate_size": 128,
         "vocab_size": 512, "num_hidden_layers": 3}
MIX = {"requests_per_batch": 6, "pool": 2,
       "prompt_len": {"median": 12, "sigma": 0.5, "min": 8, "max": 24},
       "output_len": {"median": 6, "sigma": 0.5, "min": 4, "max": 12}, "check_requests": 3}
SEED = 2 ** 31 + 77


def config(dtype: str = "float32", ep_slots: int = 4, lanes: int = 4) -> dict:
    """The serving cell's configuration at the SMOKE widths, in ``dtype``."""
    c = spec.load_cell("dsv2-conv-batch").config
    return dict(c, **SMOKE, port=dict(c["port"], param_dtype=dtype, compute_dtype=dtype,
                                      ep_slots=ep_slots),
                engine=dict(c["engine"], lanes=lanes, max_len=MIX["prompt_len"]["max"]
                            + MIX["output_len"]["max"]))


def cell(dtype: str = "float32", **kw):
    """The serving cell at the SMOKE widths and a small traffic mix."""
    c = spec.load_cell("dsv2-conv-batch")
    return dataclasses.replace(c, config=config(dtype, **kw), traffic=dict(c.traffic, **MIX))
