"""gemma3-27b — dense, 5:1 local:global, 128k. [hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=21504, vocab=262_144,
    act="geglu", qk_norm=True, tie_embeddings=True,
    window=1024, local_global_period=6, rope_theta=1_000_000.0)
