"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=6400,
16 experts top-2, vocab 32064.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]

PhiMoE uses LayerNorm and sparsemixer routing; the reference (and this
port) use standard top-2 softmax routing (noted simplification) with
LayerNorm.  Copied from ``repro.configs.phi35_moe_42b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=6400,
    vocab=32_064,
    d_head=128,
    n_experts=16,
    top_k=2,
    act="swiglu",
    norm="layernorm",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=160, vocab=512,
    d_head=32, n_experts=8, top_k=2, attn_chunk=64, remat=False)
