"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) d_ff=7680,
vocab 256000 — RG-LRU + local attention, 1 attention per 2 recurrent
blocks.  [arXiv:2402.19427; hf]

26 layers = 8 × (rec, rec, local-attn) + 2 trailing recurrent blocks.
Gemma-style: tied embeddings, sqrt(d) embed scale, GeGLU, logit softcap.
10 heads don't divide the model axis; head_dim=256, local window 2048.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_ff=7680,
    vocab=256_000,
    d_head=256,
    attn_type="local",
    window=2048,
    lru_width=2560,
    conv_width=4,
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
    logit_softcap=30.0,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=6, d_model=128, n_heads=2, n_kv=1, d_ff=256, vocab=512,
    d_head=64, window=64, lru_width=128, attn_chunk=32, remat=False)
