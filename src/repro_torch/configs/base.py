"""Model configuration dataclass (counterpart of
``repro.configs.base.ModelConfig``): the reference's fields that the
port's families (dense, moe, mla_moe, hybrid, ssm, audio, vlm) read."""

from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core.formats import MOSS_CONFIG, QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "mla_moe", "hybrid", "ssm",
                    "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                    # 0 -> d_model // n_heads

    # --- attention ---
    attn_type: Literal["full", "swa", "local"] = "full"
    window: int = 4096                 # "swa" / "local": keys a query sees
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0
    qk_norm: bool = False
    logit_softcap: float = 0.0

    # --- FFN ---
    act: Literal["swiglu", "geglu", "gelu_mlp", "relu2"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"

    # --- MoE (the reference's names and defaults) ---
    n_experts: int = 0
    n_shared: int = 0                  # shared experts (width n_shared·d_ff)
    top_k: int = 0
    capacity_factor: float = 1.3
    dense_ff: int = 0                  # width of the non-MoE FFN layers
    first_dense: int = 0               # leading layers with a dense FFN
    moe_decode_dense: bool = True      # small T: masked dense experts

    # --- MLA (deepseek) ---
    kv_lora: int = 0                   # latent width of the K/V cache
    q_nope: int = 128
    q_rope: int = 64
    v_head: int = 128

    # --- hybrid (recurrentgemma): the RG-LRU block ---
    lru_width: int = 0
    conv_width: int = 4

    # --- ssm (rwkv6): the time mix's heads and LoRA ranks ---
    rwkv_head_dim: int = 64
    ddlerp_rank: int = 32
    decay_rank: int = 64

    # --- io / misc ---
    input_mode: Literal["tokens", "embeddings"] = "tokens"
    pos_embedding: Literal["rope", "sinusoidal", "none"] = "rope"
    tie_embeddings: bool = False
    embed_scale: bool = False
    norm_eps: float = 1e-5

    attn_chunk: int = 512              # flash-chunk size (queries and kv)
    remat: bool = True                 # recompute each layer in backward
    kv_cache_dtype: Literal["bf16", "fp8"] = "fp8"

    quant: QuantConfig = MOSS_CONFIG

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
