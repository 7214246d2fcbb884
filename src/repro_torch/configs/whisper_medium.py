"""whisper-medium — enc-dec audio, conv frontend STUB. [arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=51_865,
    act="gelu", enc_layers=24, dec_layers=24, rope_theta=10_000.0)
