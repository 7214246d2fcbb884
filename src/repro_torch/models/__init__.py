"""The model substrate, ported for serving and training: layers and
losses, attention (with the int8 KV cache and cross attention), MoE, Mamba2
blocks, the transformer (dense, MoE, VLM; uniform or local:global layers),
the Mamba2 LM, the Zamba2 hybrid and the enc-dec model, each with its
``loss_fn``, construction, input specs and the carry-over of the
reference's parameters."""
from .attention import (attn_decode, attn_prefill, cross_attn_apply,
                        cross_kv, dequantize_kv, grow_cache, init_cache,
                        quantize_kv)
from .convert import params_from_reference, shard_state_dict
from .encdec import CROSS_FRAMES, EncDecLM
from .hybrid import MambaLM, Zamba2LM
from .layers import NO_MESH, P, Sharding, mlp_apply, rms_norm, rope
from .model_zoo import (batch_pspecs, build_model, cache_len_for,
                        input_specs, model_flops, param_count, skip_reason,
                        supports_shape)
from .moe import moe_apply
from .transformer import TransformerLM

__all__ = ["attn_decode", "attn_prefill", "cross_attn_apply", "cross_kv",
           "dequantize_kv", "grow_cache", "init_cache", "quantize_kv",
           "params_from_reference", "shard_state_dict",
           "CROSS_FRAMES", "P", "Sharding", "NO_MESH", "batch_pspecs",
           "EncDecLM", "mlp_apply",
           "rms_norm", "rope", "build_model", "cache_len_for",
           "input_specs", "model_flops", "param_count",
           "skip_reason", "supports_shape", "moe_apply", "TransformerLM",
           "MambaLM", "Zamba2LM"]
