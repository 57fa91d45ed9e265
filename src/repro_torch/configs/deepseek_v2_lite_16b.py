"""deepseek-v2-lite-16b [mla_moe]: 27L d=2048 16H MLA(kv_lora=512) MoE
64e top-6 + 2 shared, vocab 102400.  [arXiv:2405.04434; hf]

The published DeepSeek-V2-Lite config has 64 routed experts and 2
shared ones, top-6 routing; its first layer has a dense FFN of width
10,944.  Copied from ``repro.configs.deepseek_v2_lite_16b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,                 # per-expert intermediate
    vocab=102_400,
    d_head=128,
    n_experts=64,
    n_shared=2,
    top_k=6,
    first_dense=1,
    dense_ff=10_944,
    kv_lora=512,
    q_nope=128,
    q_rope=64,
    v_head=128,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3, d_model=128, n_heads=4, n_kv=4, d_ff=96, vocab=512,
    d_head=32, n_experts=8, top_k=2, n_shared=1, first_dense=1,
    dense_ff=256, kv_lora=64, q_nope=32, q_rope=16, v_head=32,
    attn_chunk=64, remat=False)
