"""LLaMA-2-7B: the paper's fine-tuning base model (paper Table 8: 32L
d=4096 32H, seq 4096) -- RoPE SwiGLU RMSNorm, untied.  [arXiv:2307.09288]
Copied from ``repro.configs.llama2_7b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=11_008,
    vocab=32_000,
    d_head=128,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    d_head=32, attn_chunk=64, remat=False)
