"""internvl2-2b — InternViT STUB + InternLM2 backbone. [arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92_553,
    act="swiglu", vision_tokens=1024, rope_theta=1_000_000.0)
