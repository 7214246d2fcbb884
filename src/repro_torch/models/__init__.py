"""The model substrate, ported for serving: layers, attention, Mamba2
blocks, the dense transformer, the Mamba2 LM and the Zamba2 hybrid,
construction and the carry-over of the reference's parameters."""
from .attention import attn_decode, attn_prefill, grow_cache, init_cache
from .convert import params_from_reference
from .hybrid import MambaLM, Zamba2LM
from .layers import mlp_apply, rms_norm, rope
from .model_zoo import (build_model, model_flops, param_count, skip_reason,
                        supports_shape)
from .transformer import TransformerLM

__all__ = ["attn_decode", "attn_prefill", "grow_cache", "init_cache",
           "params_from_reference", "mlp_apply", "rms_norm", "rope",
           "build_model", "model_flops", "param_count", "skip_reason",
           "supports_shape", "TransformerLM", "MambaLM", "Zamba2LM"]
