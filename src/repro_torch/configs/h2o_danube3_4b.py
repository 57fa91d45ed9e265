"""h2o-danube-3-4b [dense]: 24L d=3840 32H (GQA kv=8) d_ff=10240,
vocab 32000 -- llama+mistral mix with sliding-window attention (window
4096).  [arXiv:2401.16818; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv=8,
    d_ff=10_240,
    vocab=32_000,
    d_head=120,
    attn_type="swa",
    window=4096,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    d_head=32, window=64, attn_chunk=32, remat=False)
