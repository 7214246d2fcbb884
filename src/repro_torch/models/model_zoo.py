"""Model construction and analytic counts — the port of
``repro/models/model_zoo.py``.

``build_model`` builds every family the reference builds: the dense, MoE
and VLM families (``TransformerLM``), the SSM family (``MambaLM``), the
hybrid (``Zamba2LM``) and the enc-dec model (``EncDecLM``).
``supports_shape``, ``skip_reason``, ``param_count`` and
``model_flops`` are plain Python, copied from the reference.
``input_specs`` gives the inputs of the step a shape exercises as tensors
on the ``meta`` device (shapes and dtypes, no storage), where the
reference gives ``jax.ShapeDtypeStruct``s; ``batch_pspecs`` their specs
(``layers.P``), the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from .encdec import EncDecLM
from .hybrid import MambaLM, Zamba2LM
from .layers import P
from .transformer import TransformerLM

__all__ = ["build_model", "input_specs", "cache_len_for", "supports_shape",
           "skip_reason", "model_flops", "param_count", "batch_pspecs"]


def build_model(cfg: ModelConfig, device=None, mesh=None,
                data_axes: Tuple[str, ...] = ("data",),
                moe_impl: str = "scatter"):
    """The model for ``cfg`` on ``device`` (``cuda`` unless told). On a
    ``mesh`` (``launch.mesh``) every family holds this rank's slices of
    its ``param_pspecs()`` and runs tensor-parallel over the model axis,
    a served batch's rows split over ``data_axes``; an MoE model with
    ``moe_impl="a2a"`` dispatches its experts over the mesh."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, device=device, moe_impl=moe_impl,
                             mesh=mesh, data_axes=data_axes)
    if cfg.family == "ssm":
        return MambaLM(cfg, device=device, mesh=mesh, data_axes=data_axes)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, device=device, mesh=mesh, data_axes=data_axes)
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device, mesh=mesh, data_axes=data_axes)
    raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


# ---------------------------------------------------------------------------
# shape applicability
# ---------------------------------------------------------------------------

def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name.startswith("long"):
        if cfg.family in ("ssm", "hybrid"):
            return True
        # uniform sliding-window (mixtral) qualifies; periodic local:global
        # (gemma3) still has full-attention layers -> skip
        return cfg.window > 0 and cfg.local_global_period == 0
    return True


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str:
    if supports_shape(cfg, shape):
        return ""
    return ("pure full attention at 512k context (no sub-quadratic path); "
            "skipped per assignment")


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The batch of the step ``shape`` exercises, as meta tensors: a train
    batch holds one token more than the sequence (the labels' shift); the
    enc-dec model's sequence is its encoder's frames, with ``seq // 8``
    decoder tokens; the VLM's vision embeddings take up to a quarter of
    it; a decode step is one token and a position."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    extra = 1 if shape.kind == "train" else 0
    if shape.kind == "decode":
        return {"token": _sd((b, 1), i32), "pos": _sd((), i32)}
    if cfg.family == "encdec":
        return {"audio_embeds": _sd((b, s, cfg.d_model), f32),
                "tokens": _sd((b, s // 8 + extra), i32)}
    if cfg.family == "vlm":
        tv = min(cfg.vision_tokens, max(s // 4, 8))
        return {"vision": _sd((b, tv, cfg.d_model), f32),
                "tokens": _sd((b, s - tv + extra), i32)}
    return {"tokens": _sd((b, s + extra), i32)}


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec,
                 data_axes: Tuple[str, ...]) -> Dict[str, Any]:
    """The inputs' specs: batch on the data axes, ``pos`` replicated, a
    batch of 1 replicated."""
    ba = data_axes if len(data_axes) > 1 else data_axes[0]
    specs = input_specs(cfg, shape)

    def spec_for(name, sd):
        if name == "pos":
            return P()
        if shape.global_batch == 1:
            return P(*([None] * sd.dim()))
        return P(*([ba] + [None] * (sd.dim() - 1)))

    return {k: spec_for(k, v) for k, v in specs.items()}


def cache_len_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    return shape.seq_len


# ---------------------------------------------------------------------------
# analytic parameter / FLOP counts (roofline MODEL_FLOPS)
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, v = cfg.d_model, cfg.vocab
    n = v * d                                   # embed
    if not cfg.tie_embeddings and cfg.family != "ssm":
        n += v * d

    def attn_params():
        return d * cfg.n_heads * cfg.head_dim * 2 \
            + d * cfg.n_kv_heads * cfg.head_dim * 2

    def mlp_params(ff):
        mult = 3 if cfg.act in ("swiglu", "geglu") else 2
        return mult * d * ff

    def mamba_params():
        din, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        return d * din * 2 + d * ns * 2 + d * h + din * d \
            + cfg.ssm_conv * (din + 2 * ns)

    if cfg.family in ("dense", "vlm"):
        n += cfg.n_layers * (attn_params() + mlp_params(cfg.d_ff))
    elif cfg.family == "moe":
        e = cfg.top_k if active_only else cfg.n_experts
        per = attn_params() + e * 3 * d * cfg.d_ff + d * cfg.n_experts
        if cfg.moe_dense_residual:
            per += mlp_params(cfg.d_ff_dense)
        n += cfg.n_layers * per
    elif cfg.family == "ssm":
        n += cfg.n_layers * mamba_params()
    elif cfg.family == "hybrid":
        n += cfg.n_layers * mamba_params()
        n += attn_params() + mlp_params(cfg.d_ff)   # shared block, once
    elif cfg.family == "encdec":
        n += cfg.enc_layers * (attn_params() + mlp_params(cfg.d_ff))
        n += cfg.dec_layers * (2 * attn_params() + mlp_params(cfg.d_ff))
    if cfg.family == "vlm":
        n += d * d                              # vision projection stub
    return int(n)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params
    (matmul params only — embedding lookup excluded), D = tokens."""
    n_active = param_count(cfg, active_only=True)
    n_active -= cfg.vocab * cfg.d_model         # lookup is not a matmul
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
