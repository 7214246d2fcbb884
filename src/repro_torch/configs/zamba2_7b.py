"""zamba2-7b — Mamba2 backbone + shared attn blocks. [arXiv:2411.15242; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32_000,
    act="swiglu", ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_attn_every=6)
