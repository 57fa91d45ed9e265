"""phi3-mini-3.8b [dense]: 32L d=3072 32H (GQA kv=32 = MHA) d_ff=8192,
vocab 32064 -- RoPE SwiGLU.  [arXiv:2404.14219]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32_064,
    d_head=96,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    d_head=32, attn_chunk=64)
