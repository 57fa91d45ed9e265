"""minitron-8b [dense]: 32L d=4096 32H (GQA kv=8) d_ff=16384,
vocab 256000 — pruned Nemotron-4 (squared-ReLU MLP, partial rotary,
LayerNorm).  [arXiv:2407.14679; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=16_384,
    vocab=256_000,
    d_head=128,
    act="relu2",
    norm="layernorm",
    rope_pct=0.5,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    d_head=32, attn_chunk=64, remat=False)
