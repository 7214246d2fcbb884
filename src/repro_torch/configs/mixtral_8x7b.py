"""mixtral-8x7b — MoE 8e top-2, SWA 4096. [arXiv:2401.04088; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32_000,
    act="swiglu", n_experts=8, top_k=2, window=4096,
    rope_theta=1_000_000.0)
