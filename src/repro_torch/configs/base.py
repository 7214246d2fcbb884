"""Model/shape configuration dataclasses shared by all architectures."""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field values follow the assignment block verbatim;
    reduced smoke variants are produced by ``reduced()``."""
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    act: str = "swiglu"         # swiglu | geglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0

    # attention pattern: period P with `global_every`-th layer global, rest
    # local with `window`. window == 0 -> all layers global full attention.
    window: int = 0
    local_global_period: int = 0   # 0 = uniform (all global, or all local
    #                                if window > 0, e.g. mixtral SWA)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    d_ff_dense: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): one *shared* attention block after every
    # `hybrid_attn_every` mamba blocks
    hybrid_attn_every: int = 0

    # enc-dec (whisper): n_layers applies to BOTH encoder and decoder
    enc_layers: int = 0
    dec_layers: int = 0

    # vlm: number of (precomputed, stubbed) vision patch embeddings that
    # prefix the token sequence
    vision_tokens: int = 0

    # runtime
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    use_pallas: bool = False     # TPU path; dry-run/CPU uses the XLA path

    # perf knobs (§Perf hillclimbs; defaults = paper-faithful baseline)
    moe_shard: str = "ep_ftp"    # ep_ftp | ep_fsdp | ep_only (see moe.py)
    ce_chunk: int = 0            # vocab-chunked CE: sequence chunk count
    kv_dtype: str = "model"      # model | int8 (quantized KV cache)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_is_global(self, i: int) -> bool:
        if self.window == 0:
            return True
        if self.local_global_period == 0:
            return False                      # uniform SWA (mixtral)
        # gemma3 pattern: every `period`-th layer (1-based) is global
        return (i + 1) % self.local_global_period == 0

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        period = self.local_global_period
        n_layers = max(4, period) if period else 4
        if self.family == "hybrid":
            n_layers = 2 * max(self.hybrid_attn_every and 2 or 2, 2) + 1  # 5
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128, d_ff_dense=64 if self.d_ff_dense else 0,
            vocab=256,
            n_experts=4 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 32) if self.window else 0,
            local_global_period=min(period, 2) if period else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 256,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            dec_layers=2 if self.dec_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)
