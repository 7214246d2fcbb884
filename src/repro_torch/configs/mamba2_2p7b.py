"""mamba2-2.7b — SSM (SSD), attention-free. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=50_280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4)
