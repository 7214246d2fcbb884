"""Mixture-of-Experts FFN (mixtral-style top-k; arctic adds a dense
residual branch) — the port of ``repro/models/moe.py`` with both of its
dispatches, ``scatter`` and ``a2a``.

Tokens are ranked within their chosen expert by a cumsum over a
(tokens·k, E) one-hot, written into an (E·C + 1, D) buffer whose last row
takes the entries past an expert's capacity C, run through the experts as
batched (E, C, D) × (E, D, F) products and gathered back with their router
weights. Every token keeps its entries (C = T) while the batch holds at
most 8,192 tokens; above that C = ``capacity_factor · top_k · T / E`` and
the latest entries of a full expert are dropped. The router runs in
float32 whatever the model's dtype, the top-k probabilities are a softmax
over the chosen logits, and the switch-style load-balance loss is returned
for training.

Nothing here is a kernel, in the reference either: the expert products are
``torch.bmm`` (cuBLAS on the card), the dispatch is indexing.

``a2a`` is expert parallelism over a device mesh (``launch.mesh``), the
reference's ``shard_map`` body run on every rank: experts are split over
the mesh's model axis (a rank holds its ``E/m``), tokens over its data
axes. The input and the output are the global view, as the reference's
single controller sees them: each rank takes its data shard's ``t/n``
rows, routes them, lays out an ``(m, e_local·cap, d)`` send buffer (one
lane per model rank, capacity per lane), exchanges it with
``all_to_all_single`` over the model axis, runs its local experts,
exchanges the results back, combines them and all-gathers the rows over
the data axes. The aux loss is data shard 0's, averaged over the model
axis (what the reference returns), and its gradient is that of the mean
over the data shards (what the reference differentiates). Backward
follows the same view: every rank's gradient is the reference's gradient
of the one global loss (an expert bank's, this rank's slice of it).

Parameters, in the reference's layouts: ``router (d, E)`` float32, ``wi``,
``wg (E, d, F)``, ``wo (E, F, d)``, and for arctic ``dense.{wi, wg, wo}``.
"""
from __future__ import annotations

import math
import warnings
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import dense_init, he_init, init_mlp, mlp_apply, mlp_params

__all__ = ["MoE", "moe_apply", "capacity", "check_impl", "expert_range",
           "EXACT_TOKENS"]

#: tokens up to which routing keeps every entry (capacity = tokens)
EXACT_TOKENS = 8192


def check_impl(impl: str, mesh=None) -> None:
    """``scatter``, or ``a2a`` over a ``mesh``."""
    if impl not in ("scatter", "a2a"):
        raise ValueError(f"unknown moe_impl {impl!r}")
    if impl == "a2a" and mesh is None:
        raise ValueError("moe_impl='a2a' needs a device mesh "
                         "(launch.mesh)")


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def expert_range(cfg: ModelConfig, mesh=None,
                 model_axis: str = "model") -> Tuple[int, int]:
    """The experts ``[lo, hi)`` this rank holds: all of them without a
    mesh, its model coordinate's ``E/m`` on one."""
    e = cfg.n_experts
    if mesh is None or mesh.get_coordinate() is None:
        return 0, e
    m = _axis_size(mesh, model_axis)
    if e % m:
        raise ValueError(f"n_experts must divide model axis ({e} experts "
                         f"over {m})")
    i = int(mesh.get_coordinate()[mesh.mesh_dim_names.index(model_axis)])
    return i * (e // m), (i + 1) * (e // m)


class MoE(nn.Module):
    """An MoE layer's parameters, read by name (``p["wi"]``, ``"dense" in
    p``) as ``moe_apply`` reads the reference's dict."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device,
                 experts: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.experts = experts or (0, cfg.n_experts)
        d, f = cfg.d_model, cfg.d_ff
        e = self.experts[1] - self.experts[0]

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.router = empty(d, cfg.n_experts, dt=torch.float32)
        self.wi, self.wg, self.wo = empty(e, d, f), empty(e, d, f), \
            empty(e, f, d)
        if cfg.moe_dense_residual:
            self.dense = mlp_params(d, cfg.d_ff_dense, cfg.act, dtype, device)
        self.cfg = cfg

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        """He-normal router and experts from ``gen``, drawn into place; a
        rank holding a slice of the experts draws every bank whole and
        keeps its slice, so the weights are the unsharded model's."""
        d, f, e = self.cfg.d_model, self.cfg.d_ff, self.cfg.n_experts
        dense_init(gen, d, e, torch.float32, out=self.router)
        lo, hi = self.experts
        for w, fan_in in ((self.wi, d), (self.wg, d), (self.wo, f)):
            if hi - lo == e:
                he_init(gen, tuple(w.shape), fan_in, w.dtype, out=w)
            else:
                w.copy_(he_init(gen, (e, *w.shape[1:]), fan_in,
                                w.dtype)[lo:hi])
        if "dense" in self:
            init_mlp(self.dense, gen)


def _route(p: Mapping[str, torch.Tensor], x2d: torch.Tensor,
           cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, D) -> (probs (T,k) float32, idx (T,k) int64, aux ()).

    The top k in ``lax.top_k``'s order: descending, the lower expert first
    on a tie (a stable sort), since the dispatch ranks follow it."""
    logits = x2d.float() @ p["router"]                        # (T, E)
    gates = torch.softmax(logits, dim=-1)
    top_v, top_i = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = torch.softmax(top_v, dim=-1)                      # renormalize
    # switch-style load-balance loss: E * sum_e fraction_e * prob_e
    e = cfg.n_experts
    frac = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(frac * gates.mean(dim=0))
    return top_p, top_i, aux


def _expert_ffn(wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                xs: torch.Tensor, act: str) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D) with per-expert weights."""
    h, hi = torch.bmm(xs, wg), torch.bmm(xs, wi)
    if act == "geglu":
        h = F.gelu(h, approximate="tanh") * hi
    else:
        h = F.silu(h) * hi
    return torch.bmm(h, wo)


def _dispatch_ranks(top_i: torch.Tensor, e: int) -> torch.Tensor:
    """Position of each (token, k) entry within its expert's queue,
    token-major: top_i (T, k) -> ranks (T, k), from a cumsum over the
    (T·k, E) one-hot."""
    flat = top_i.reshape(-1)
    onehot = F.one_hot(flat, e)
    ranks = onehot.cumsum(dim=0) - onehot
    return ranks.gather(1, flat[:, None]).reshape(top_i.shape)


def _moe_scatter(p: Mapping[str, torch.Tensor], x2d: torch.Tensor,
                 cfg: ModelConfig, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    top_p, top_i, aux = _route(p, x2d, cfg)
    ranks = _dispatch_ranks(top_i, e)                         # (T, k)
    # dropped entries write to (and later read) the spill row
    slot = torch.where(ranks < capacity, top_i * capacity + ranks,
                       e * capacity).reshape(-1)
    buf = x2d.new_zeros((e * capacity + 1, d))
    buf[slot] = x2d.repeat_interleave(k, dim=0)               # token-major
    ys = _expert_ffn(p["wi"], p["wg"], p["wo"],
                     buf[:-1].reshape(e, capacity, d), cfg.act)
    flat = torch.cat([ys.reshape(e * capacity, d), ys.new_zeros((1, d))])
    gathered = flat[slot].reshape(t, k, d)
    y = torch.sum(gathered * top_p[..., None].to(gathered.dtype), dim=1)
    return y, aux


def capacity(cfg: ModelConfig, t: int) -> int:
    """Entries an expert takes for a batch of ``t`` tokens."""
    if t <= EXACT_TOKENS:
        return t
    return max(1, int(cfg.capacity_factor * cfg.top_k * t / cfg.n_experts))


class _Shard(torch.autograd.Function):
    """Rows ``[r·t/n, (r+1)·t/n)`` of a replicated ``(t, d)``; backward
    all-gathers the blocks' gradients over the data group, so every rank
    holds the replicated input's whole gradient."""

    @staticmethod
    def forward(ctx, x, r: int, n: int, group):
        ctx.n, ctx.group = n, group
        t_l = x.shape[0] // n
        return x[r * t_l:(r + 1) * t_l].clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.n, ctx.group), None, None, None


class _GatherRows(torch.autograd.Function):
    """Every data shard's ``(t/n, d)`` rows, all-gathered in data order;
    backward keeps this shard's rows of the gradient, which every rank
    holds whole (the loss is the same global one on every rank)."""

    @staticmethod
    def forward(ctx, y, r: int, n: int, group):
        ctx.r, ctx.t_l = r, y.shape[0]
        return _all_gather(y, n, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.r * ctx.t_l:(ctx.r + 1) * ctx.t_l], None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over ``group`` and scales
    it: a weight replicated over the data shards, each of which sees only
    its own tokens (``scale`` undoes the model ranks' copies of them)."""

    @staticmethod
    def forward(ctx, w, group, scale: float):
        ctx.group, ctx.scale = group, scale
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if ctx.scale != 1.0:
            g = g * ctx.scale
        return g, None, None


class _AuxOf(torch.autograd.Function):
    """``val`` (data shard 0's aux on every rank) forward; backward gives
    this shard's ``aux`` the gradient over ``n``: summed over the shards
    by the router's ``_SumGrad``, that is the gradient of their mean."""

    @staticmethod
    def forward(ctx, aux, val, n: int):
        ctx.n = n
        return val.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _all_gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over ``group`` with autograd (its backward is
    the reverse exchange)."""
    from torch.distributed.nn.functional import all_to_all_single
    with warnings.catch_warnings():     # deprecated in favour of a private
        warnings.simplefilter("ignore", FutureWarning)   # module
        return all_to_all_single(torch.empty_like(x), x.contiguous(),
                                 group=group)


def _moe_a2a(p: Mapping[str, torch.Tensor], x2d: torch.Tensor,
             cfg: ModelConfig, capacity: int, mesh,
             data_axes: Tuple[str, ...], model_axis: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch with ``all_to_all_single`` along the
    model axis: experts sharded over ``model_axis``, tokens over
    ``data_axes``; ``capacity`` is per (rank, remote rank) lane."""
    from ..launch.mesh import data_group, data_index
    e, k = cfg.n_experts, cfg.top_k
    m = _axis_size(mesh, model_axis)
    if e % m:
        raise ValueError(f"n_experts must divide model axis ({e} experts "
                         f"over {m})")
    e_local = e // m
    n = math.prod(_axis_size(mesh, a) for a in data_axes)
    t, d = x2d.shape
    if t % n:
        raise ValueError(f"{t} tokens do not split over {n} data shards "
                         f"(the reference's shard_map needs t % n == 0)")
    r = data_index(mesh, data_axes)
    mgroup, dgroup = mesh.get_group(model_axis), data_group(mesh, data_axes)
    x_loc = _Shard.apply(x2d, r, n, dgroup)
    t_l = x_loc.shape[0]
    router = _SumGrad.apply(p["router"], dgroup, 1.0)
    top_p, top_i, aux = _route({"router": router}, x_loc, cfg)
    ranks = _dispatch_ranks(top_i, e)
    # lane layout: (m destination ranks, e_local experts, capacity)
    dest, eloc = top_i // e_local, top_i % e_local
    slot = torch.where(ranks < capacity,
                       dest * (e_local * capacity) + eloc * capacity + ranks,
                       m * e_local * capacity).reshape(-1)
    buf = x_loc.new_zeros((m * e_local * capacity + 1, d))
    buf[slot] = x_loc.repeat_interleave(k, dim=0)             # token-major
    recv = _all_to_all(buf[:-1], mgroup)
    # recv: (m, e_local·capacity, d), every model rank's tokens for ours
    xs = recv.reshape(m, e_local, capacity, d).transpose(0, 1) \
        .reshape(e_local, m * capacity, d)
    wi, wg, wo = (_SumGrad.apply(p[w], dgroup, 1.0 / m)
                  for w in ("wi", "wg", "wo"))
    ys = _expert_ffn(wi, wg, wo, xs, cfg.act)
    back = _all_to_all(ys.reshape(e_local, m, capacity, d).transpose(0, 1)
                       .reshape(m * e_local * capacity, d), mgroup)
    flat = torch.cat([back, back.new_zeros((1, d))])
    gathered = flat[slot].reshape(t_l, k, d)
    y = torch.sum(gathered * top_p[..., None].to(gathered.dtype), dim=1)
    # the value: data shard 0's aux averaged over the model axis; the
    # gradient: that of the data shards' mean (see the module docstring)
    val = aux.detach().clone()
    dist.all_reduce(val, group=mgroup)
    val = val / m if r == 0 else torch.zeros_like(val)
    dist.all_reduce(val, group=dgroup)
    return _GatherRows.apply(y, r, n, dgroup), _AuxOf.apply(aux, val, n)


def moe_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, impl: str = "scatter", mesh=None,
              data_axes: Tuple[str, ...] = ("data",),
              model_axis: str = "model"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B,S,D), aux_loss ()), the dense residual
    included. ``impl="a2a"`` dispatches over ``mesh`` (tokens over
    ``data_axes``, experts over ``model_axis``; ``p`` holds this rank's
    experts) and needs every rank of the mesh to call it alike."""
    check_impl(impl, mesh)
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    if impl == "a2a":
        m = _axis_size(mesh, model_axis)
        n_data = math.prod(_axis_size(mesh, a) for a in data_axes)
        t_l = t // max(1, n_data)
        cap_l = t_l if t <= EXACT_TOKENS else max(
            1, int(cfg.capacity_factor * cfg.top_k * t_l
                   / (cfg.n_experts * max(1, m))))
        y, aux = _moe_a2a(p, x2d, cfg, cap_l, mesh, data_axes, model_axis)
    else:
        y, aux = _moe_scatter(p, x2d, cfg, capacity(cfg, t))
    y = y.reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(p["dense"], x, cfg.act)
    return y, aux
