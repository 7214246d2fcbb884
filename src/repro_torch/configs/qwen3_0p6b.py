"""qwen3-0.6b — dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072, vocab=151_936,
    act="swiglu", qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0)
