"""musicgen-medium [audio]: 48L d=1536 24H (MHA) d_ff=6144, vocab 2048 --
decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

The backbone only: the EnCodec frontend and the 4-codebook delay pattern
are stubbed, as in the reference.  Training takes precomputed frame
embeddings (B, S, d) (``launch.train``'s frontend stub) and
single-stream labels over the 2048-entry codebook; the legacy ``Server``
serves token prompts through the embedding table.  Sinusoidal
positions, LayerNorm, GELU MLP.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv=24,
    d_ff=6144,
    vocab=2048,
    d_head=64,
    act="gelu_mlp",
    norm="layernorm",
    input_mode="embeddings",
    pos_embedding="sinusoidal",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=96, n_heads=3, n_kv=3, d_ff=192, vocab=128,
    d_head=32, attn_chunk=64, remat=False)
