"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) d_ff=13824,
vocab 100352.  [hf:stabilityai/stablelm-2-12b; hf]

StableLM-2-12B: LayerNorm, partial rotary (25%), per-head qk-norm.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    d_ff=13_824,
    vocab=100_352,
    d_head=160,
    act="swiglu",
    norm="layernorm",
    rope_pct=0.25,
    qk_norm=True,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    d_head=32, attn_chunk=64, remat=False)
