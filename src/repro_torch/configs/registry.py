"""--arch id -> config module registry (the archs ported so far)."""

from __future__ import annotations

import importlib

from .base import ModelConfig

ARCHS: dict[str, str] = {
    "phi3-mini-3.8b": "phi3_mini_38b",
    "olmo-7b": "olmo_7b",
    "llama2-7b": "llama2_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
}

# reference archs whose families or features the port does not have yet
NOT_PORTED = {
    "deepseek-v2-lite-16b": "queue 1 item 10 (MLA, shared experts)",
    "stablelm-12b": "queue 1 item 11 (qk-norm, partial rotary)",
    "minitron-8b": "queue 1 item 11 (squared-ReLU, partial rotary)",
    "musicgen-medium": "queue 1 item 11 (embeddings input)",
    "recurrentgemma-2b": "queue 1 item 11 (RG-LRU hybrid)",
    "phi-3-vision-4.2b": "queue 1 item 11 (vision)",
    "rwkv6-3b": "queue 1 item 11 (RWKV6)",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP {NOT_PORTED[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
