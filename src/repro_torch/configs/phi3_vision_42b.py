"""phi-3-vision-4.2b [vlm]: phi3-mini backbone (32L d=3072 32H MHA
d_ff=8192 vocab 32064) + CLIP frontend.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The backbone only: the CLIP image tower is stubbed, as in the reference.
Training takes precomputed patch and text embeddings (B, S, d)
(``launch.train``'s frontend stub); labels target the text token stream.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32_064,
    d_head=96,
    act="swiglu",
    norm="rmsnorm",
    input_mode="embeddings",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    d_head=32, attn_chunk=64, remat=False)
