"""--arch id -> config module registry (the reference's archs)."""

from __future__ import annotations

import importlib

from .base import ModelConfig

ARCHS: dict[str, str] = {
    "phi3-mini-3.8b": "phi3_mini_38b",
    "olmo-7b": "olmo_7b",
    "llama2-7b": "llama2_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "stablelm-12b": "stablelm_12b",
    "minitron-8b": "minitron_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-3b": "rwkv6_3b",
    "musicgen-medium": "musicgen_medium",
    "phi-3-vision-4.2b": "phi3_vision_42b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
