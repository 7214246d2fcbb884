"""Step builders for the trainer and the server: the port of
``repro/launch/steps.py``.

Each builder returns ``(model, step_fn, batch_specs)``: the model on its
device (``cuda`` unless told), the step, and its inputs as meta tensors
(``models.input_specs``). The parameters live in the model and the train
step updates them in place, where the reference's jitted step takes and
returns them (donated). ``mesh``, ``data_axes`` and ``moe_impl`` go to
``build_model``: on a mesh the model holds this rank's slices and runs
tensor-parallel (an MoE model's ``a2a`` dispatch is reached through these
builders as in the reference). Where the reference returns shardings,
the serving steps carry their specs (``layers.P``) as ``step.specs``:
``{"params", "batch"}`` for the prefill, ``{"params", "caches",
"batch"}`` for the decode (batch 1 shards the cache's sequence, as the
reference's ``shard_seq``). The train step's shardings and ZeRO-1 specs
are ROADMAP queue A item 13c.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..models import batch_pspecs, build_model, cache_len_for, input_specs
from ..optim import AdamWConfig, adamw_update, compress_error_feedback

__all__ = ["make_train_objects", "make_prefill_objects",
           "make_decode_objects"]


def _micro(batch: Mapping, accum: int, i: int) -> Dict:
    """Rows ``[i·B/accum, (i+1)·B/accum)`` of every batched input, the
    ``i``-th of the reference's ``(accum, B/accum, ...)`` micro-batches."""
    def rows(x):
        if np.ndim(x) == 0:
            return x
        per = x.shape[0] // accum
        return x[i * per:(i + 1) * per]
    return {k: rows(v) for k, v in batch.items()}


def make_train_objects(cfg: ModelConfig, shape: ShapeSpec,
                       acfg: AdamWConfig = AdamWConfig(), accum: int = 1,
                       compress: bool = False, device=None, mesh=None,
                       data_axes: Tuple[str, ...] = ("data",),
                       moe_impl: str = "scatter"):
    """The full train step: forward and backward through the model's
    ``loss_fn`` (its differentiable route), then ``adamw_update``.

    ``train_step(opt, batch) -> (opt, {"loss", "grad_norm", "lr"})`` with
    ``opt`` an ``OptState``, or with ``compress`` a pair ``(OptState,
    CompressionState)``: the gradients then pass through int8 error
    feedback before the update. With ``accum > 1`` the batch's rows are
    split into ``accum`` micro-batches whose gradients are summed in
    float32 and averaged (and their losses), as the reference's scan does.
    The model's parameters get ``requires_grad``; serving models keep
    theirs off. Under ``moe_impl="a2a"`` every rank of ``mesh`` takes the
    same step on the same global batch, and its gradients are the
    unsharded model's (its expert slices)."""
    model = build_model(cfg, device=device, mesh=mesh, data_axes=data_axes,
                        moe_impl=moe_impl)
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def value_and_grad(batch):
        loss, _ = model.loss_fn(batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        return loss.detach(), grads

    def train_step(opt, batch):
        if accum == 1:
            loss, grads = value_and_grad(batch)
        else:
            g_sum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(accum):
                l, g = value_and_grad(_micro(batch, accum, i))
                for n in params:
                    g_sum[n] += g[n]
                    params[n].grad = None
                loss = loss + l
            grads = {n: g / accum for n, g in g_sum.items()}
            loss = loss / accum
        if compress:
            opt, comp = opt
            grads, comp = compress_error_feedback(grads, comp)
        _, opt, metrics = adamw_update(grads, opt, params, acfg)
        for p in params.values():
            p.grad = None
        return ((opt, comp) if compress else opt), {"loss": loss, **metrics}

    return model, train_step, input_specs(cfg, shape)


def make_prefill_objects(cfg: ModelConfig, shape: ShapeSpec, device=None,
                         mesh=None, data_axes: Tuple[str, ...] = ("data",),
                         moe_impl: str = "scatter"):
    """Prefill step: forward, the caches grown to the shape's length, and
    the last token's logits (``prefill_step(batch) -> (logits,
    caches)``)."""
    model = build_model(cfg, device=device, mesh=mesh, data_axes=data_axes,
                        moe_impl=moe_impl)
    cache_len = cache_len_for(cfg, shape)

    @torch.no_grad()
    def prefill_step(batch):
        return model.prefill(batch, cache_len=cache_len)

    prefill_step.specs = {"params": model.param_pspecs(),
                          "batch": batch_pspecs(cfg, shape, data_axes)}
    return model, prefill_step, input_specs(cfg, shape)


def make_decode_objects(cfg: ModelConfig, shape: ShapeSpec, device=None,
                        mesh=None, data_axes: Tuple[str, ...] = ("data",),
                        moe_impl: str = "scatter"):
    """One-token serve step against caches of the shape's length
    (``serve_step(caches, {"token", "pos"}) -> (logits, caches)``, the
    caches updated in place; ``model.init_caches(batch, cache_len_for(cfg,
    shape))`` makes empty ones)."""
    model = build_model(cfg, device=device, mesh=mesh, data_axes=data_axes,
                        moe_impl=moe_impl)

    @torch.no_grad()
    def serve_step(caches, batch):
        return model.decode_step(caches, batch)

    serve_step.specs = {
        "params": model.param_pspecs(),
        "caches": model.cache_pspecs(shard_seq=shape.global_batch == 1),
        "batch": batch_pspecs(cfg, shape, data_axes)}
    return model, serve_step, input_specs(cfg, shape)
