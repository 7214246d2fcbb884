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
the steps carry their specs (``layers.P``) as ``step.specs``: ``{"params",
"opt", "batch"}`` for the train step (the reference's ``in_sh``: the
optimiser state's from ``zero1_pspecs``), ``{"params", "batch"}`` for the
prefill, ``{"params", "caches", "batch"}`` for the decode (batch 1 shards
the cache's sequence, as the reference's ``shard_seq``).

The train step on a mesh runs what the reference's single jitted program
runs, rank by rank: each rank takes its data shard's rows of each
micro-batch (micro-batch ``i`` is the global rows ``[i·B/accum,
(i+1)·B/accum)``) through the model's ``loss_fn(local_rows=True)``,
tensor-parallel over the model axis, whose loss is the whole batch's on
every rank; the gradients are summed over the data shards (each rank's
is its rows' part, ``models.moe`` for the banks sharded over "data"),
clipped by the norm of the whole tree, and each rank updates its ZeRO-1
slice of the moments and of every parameter, then all-gathers the
parameter over the data axes (``MeshPlan``). Without a mesh each of
these steps is the identity (one data shard, no group, whole slices), so
the one step serves both.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, ShapeSpec
from ..core.collectives import all_gather, all_reduce, data_group
from ..models import batch_pspecs, build_model, cache_len_for, input_specs
from ..models.layers import P, Sharding
from ..optim import (AdamWConfig, OptState, adamw_update,
                     compress_error_feedback, global_norm, zero1_pspecs)

__all__ = ["make_train_objects", "make_prefill_objects",
           "make_decode_objects", "MeshPlan"]


def _micro(batch: Mapping, accum: int, i: int) -> Dict:
    """Rows ``[i·B/accum, (i+1)·B/accum)`` of every batched input, the
    ``i``-th of the reference's ``(accum, B/accum, ...)`` micro-batches."""
    def rows(x):
        if np.ndim(x) == 0:
            return x
        per = x.shape[0] // accum
        return x[i * per:(i + 1) * per]
    return {k: rows(v) for k, v in batch.items()}


def _axes(spec) -> Tuple[str, ...]:
    out = []
    for e in spec:
        if e is not None:
            out.extend((e,) if isinstance(e, str) else e)
    return tuple(out)


class MeshPlan:
    """Where each parameter of a model on a mesh lives, for the train step
    and the checkpoints: its spec and whole shape, its ZeRO-1 spec and
    this rank's slice of it, and the process groups its gradient is
    summed over (the data axes its spec does not hold) and its norm and
    int8 scale are taken over (the axes its spec holds). Axes of size 1
    get no group, and a group is made when first used; without a mesh
    every group is ``None`` and every slice whole."""

    def __init__(self, model, data_axes: Tuple[str, ...], zero1: bool):
        sh: Sharding = model.sh
        self.sh, self.data_axes = sh, tuple(data_axes)
        self.specs = model.param_pspecs()
        local = dict(model.named_parameters())
        self.full = {n: self._whole_shape(self.specs[n], tuple(t.shape))
                     for n, t in local.items()}
        sizes = dict(sh.sizes)
        for a in (*self.data_axes, sh.model_axis):
            sizes.setdefault(a, 1)
        self.zspecs = {n: P(*z) for n, z in zero1_pspecs(
            self.specs, self.full, sizes, self.data_axes).items()} \
            if zero1 else dict(self.specs)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.sum_axes, self.norm_axes, self.zero = {}, {}, {}
        for n in local:
            spec = self.specs[n]
            held = _axes(spec)
            self.sum_axes[n] = self._live(
                tuple(a for a in self.data_axes if a not in held))
            self.norm_axes[n] = self._live(held)
            self.zero[n] = None
            for d, (e, z) in enumerate(zip(
                    tuple(self.zspecs[n]), tuple(spec) + (None,) * 8)):
                if e != z:                 # the axis ZeRO-1 placed
                    i, k = sh.part(e)
                    if k > 1:
                        size = local[n].shape[d] // k
                        self.zero[n] = (d, i * size, size,
                                        self._live(_axes((e,))))

    def _whole_shape(self, spec, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(n * self.sh.part(spec[d] if d < len(spec) else None)[1]
                     for d, n in enumerate(shape))

    def _live(self, axes: Tuple[str, ...]) -> Tuple[str, ...]:
        """``axes`` of more than one rank, in the mesh's order."""
        if self.sh.mesh is None:
            return ()
        return tuple(a for a in self.sh.mesh.mesh_dim_names
                     if a in axes and self.sh.sizes.get(a, 1) > 1)

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes`` (``_live``'s), or None."""
        if not axes:
            return None
        if axes not in self._groups:
            self._groups[axes] = data_group(self.sh.mesh, axes)
        return self._groups[axes]

    @property
    def norm_groups(self) -> Dict[str, object]:
        """Each parameter's group for its norm and int8 scale."""
        return {n: self.group(a) for n, a in self.norm_axes.items()}

    def zslice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of ``t`` (a rank's parameter-shaped
        tensor), a view."""
        z = self.zero[name]
        return t if z is None else t.narrow(z[0], z[1], z[2])

    def moments_index(self, name: str) -> Tuple[slice, ...]:
        """This rank's slice of the whole moment tensor ``name``."""
        return self.sh.index(self.zspecs[name], self.full[name])

    def sum_data(self, grads: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Each gradient summed over its data group: one collective per
        (group, dtype), over the tensors flattened together."""
        buckets: Dict[tuple, list] = {}
        for n, g in grads.items():
            if self.sum_axes[n]:
                buckets.setdefault((self.sum_axes[n], g.dtype), []).append(n)
        out = dict(grads)
        for (axes, _), names in buckets.items():
            flat = all_reduce(torch.cat([grads[n].reshape(-1)
                                         for n in names]), self.group(axes))
            for n, part in zip(names, flat.split(
                    [grads[n].numel() for n in names])):
                out[n] = part.view(grads[n].shape)
        return out

    def whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's slice under
        ``spec``, gathered over each sharded dimension's axes (every rank
        takes part) into host memory: over ``gloo`` the slices meet
        there, over ``nccl`` on the card. ``t`` itself where nothing is
        gathered."""
        out = t
        for d, e in enumerate(spec):
            grp = self.group(self._live(_axes((e,)))) if e is not None \
                else None
            if grp is not None:
                if dist.get_backend(grp) == "gloo":
                    out = out.cpu()
                out = all_gather(out, d, grp)
        return out if out is t else out.cpu()

    @torch.no_grad()
    def gather_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Every parameter's ZeRO-1 slices, updated by their ranks,
        all-gathered over the data axes into the parameter."""
        for n, z in self.zero.items():
            if z is not None:
                d, start, size, axes = z
                params[n].copy_(all_gather(
                    params[n].narrow(d, start, size), d, self.group(axes)))


def make_train_objects(cfg: ModelConfig, shape: ShapeSpec,
                       acfg: AdamWConfig = AdamWConfig(), accum: int = 1,
                       compress: bool = False, device=None, mesh=None,
                       data_axes: Tuple[str, ...] = ("data",),
                       moe_impl: str = "scatter", zero1: bool = True):
    """The full train step: forward and backward through the model's
    ``loss_fn`` (its differentiable route), then ``adamw_update``.

    ``train_step(opt, batch) -> (opt, {"loss", "grad_norm", "lr"})`` with
    ``opt`` an ``OptState``, or with ``compress`` a pair ``(OptState,
    CompressionState)``: the gradients then pass through int8 error
    feedback before the update. With ``accum > 1`` the batch's rows are
    split into ``accum`` micro-batches whose gradients are summed in
    float32 and averaged (and their losses), as the reference's scan does.
    The model's parameters get ``requires_grad``; serving models keep
    theirs off. On a ``mesh`` (see the module's docstring) ``batch`` is
    the global batch on every rank, the moments in ``opt`` are the rank's
    ZeRO-1 slices (``zero1``; ``train_step.plan.zslice``), the residual
    of ``compress`` is shaped as the rank's parameters, and every rank
    returns the same metrics. ``train_step.specs`` are the reference's
    specs of the parameters, the optimiser state and the batch."""
    model = build_model(cfg, device=device, mesh=mesh, data_axes=data_axes,
                        moe_impl=moe_impl)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    plan = MeshPlan(model, data_axes, zero1)
    sh = model.sh

    def value_and_grad(batch):
        loss, _ = model.loss_fn({k: sh.split_rows(v)
                                 for k, v in batch.items()}, local_rows=True)
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
        grads = plan.sum_data(grads)
        if compress:
            opt, comp = opt
            grads, comp = compress_error_feedback(grads, comp,
                                                  plan.norm_groups)
        _, opt, metrics = adamw_update(
            {n: plan.zslice(n, g) for n, g in grads.items()}, opt,
            {n: plan.zslice(n, p) for n, p in params.items()}, acfg,
            gnorm=global_norm(grads, plan.norm_groups))
        plan.gather_params(params)
        for p in params.values():
            p.grad = None
        return ((opt, comp) if compress else opt), {"loss": loss, **metrics}

    z = plan.zspecs
    train_step.plan = plan
    train_step.specs = {"params": plan.specs,
                        "opt": OptState(mu=z, nu=dict(z), count=P()),
                        "batch": batch_pspecs(cfg, shape, data_axes)}
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
