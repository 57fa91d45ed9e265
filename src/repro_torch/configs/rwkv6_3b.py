"""rwkv6-3b (Finch) [ssm]: 32L d=2560 attention-free, d_ff=8960,
vocab 65536 -- data-dependent decay WKV.  [arXiv:2404.05892; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # d_model / rwkv_head_dim
    n_kv=40,
    d_ff=8960,
    vocab=65_536,
    rwkv_head_dim=64,
    ddlerp_rank=32,
    decay_rank=64,
    act="relu2",
    norm="layernorm",
    pos_embedding="none",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=2, n_kv=2, d_ff=256, vocab=512,
    rwkv_head_dim=64, ddlerp_rank=8, decay_rank=16, remat=False)
