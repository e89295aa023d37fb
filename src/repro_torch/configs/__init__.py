"""Architecture registry: one module per assigned arch, exact dims from the
assignment block. Each module exports CONFIG (full) and SMOKE (reduced twin
of the same family for CPU tests)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "starcoder2_3b",
    "qwen1_5_32b",
    "llama3_8b",
    "smollm_360m",
    "whisper_base",
    "qwen2_vl_7b",
    "xlstm_1_3b",
    "grok1_314b",
    "deepseek_v2_236b",
    "zamba2_2_7b",
]

# CLI names with dashes/dots map onto module ids.
ALIASES: Dict[str, str] = {
    "starcoder2-3b": "starcoder2_3b",
    "qwen1.5-32b": "qwen1_5_32b",
    "llama3-8b": "llama3_8b",
    "smollm-360m": "smollm_360m",
    "whisper-base": "whisper_base",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "grok-1-314b": "grok1_314b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "zamba2-2.7b": "zamba2_2_7b",
}


def _module(name: str):
    mid = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mid not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mid}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
