"""arctic-480b — MoE 128e top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=4864, vocab=32_000,
    act="swiglu", n_experts=128, top_k=2,
    moe_dense_residual=True, d_ff_dense=4864, rope_theta=10_000.0)
