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

On a device mesh (``layers.Sharding``) a layer holds its slices of
``moe_pspec``'s layout. When the experts divide the model axis the banks
are expert-parallel: ``scatter`` routes every token on every rank (the
router is replicated), runs the rank's ``E/tp`` experts on the entries
routed to them, combines those with their router weights (zero for the
others) and sums the partial outputs over the model axis. Otherwise each
expert's ``d_ff`` is split over the model axis (per-expert TP): every
rank runs every expert on its ``F/tp`` columns and the partial outputs
are summed. The second shard over "data" (``cfg.moe_shard``: ``ep_ftp``
F, ``ep_fsdp`` D, ``ep_only`` none) is gathered over the data group just
before use, by ``scatter`` and ``a2a`` alike. A server's or the mesh
train step's rows split over the data axes (``local_rows``): capacity
and the ranks within an expert are then the whole batch's (above 8,192
tokens the other shards' counts are gathered), so the same entries drop
as in the unsharded model.

Gradients on a mesh. With ``local_rows`` each rank's gradient is its own
rows' part of the gradient of the one global loss, and the train step
sums those over the data shards (``launch.steps``); a bank sharded over
"data" is the exception, its gradient summed over the data group where
it was gathered (a reduce-scatter). The sharded ``scatter`` routes every
token on every model rank, but a rank's combine sees only its experts'
(or its ``d_ff`` columns') outputs, so the tokens entering the experts
and the router weights entering the combine sum their gradients over the
model axis (``Sharding.enter``); in training (``train``) the aux loss is
the whole batch's, ``E · Σ_e frac_e · prob_e`` of the data shards' mean
fractions and probabilities, as the reference's GSPMD program computes
it. ``a2a`` keeps the reference's aux (above); with ``local_rows`` its
router and banks leave the data sum to the train step.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..core.collectives import (all_gather, all_reduce, all_to_all,
                                data_group, data_index)
from .layers import (NO_MESH, P, Sharding, dense_init, divisible, he_init,
                     init_mlp, mlp_apply, mlp_params, mlp_pspec)

__all__ = ["MoE", "moe_apply", "capacity", "check_impl", "EXACT_TOKENS",
           "moe_pspec"]

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


def moe_pspec(cfg: ModelConfig, tp: Optional[int] = None) -> dict:
    """The reference's layout: expert parallelism over "model" when the
    experts divide it, with a second shard over "data" by
    ``cfg.moe_shard``; otherwise each expert's ``d_ff`` over "model".
    arctic's dense residual follows ``mlp_pspec``."""
    if divisible(cfg.n_experts, tp):
        second = cfg.moe_shard if cfg.moe_shard in ("ep_ftp", "ep_fsdp",
                                                    "ep_only") else "ep_ftp"
        if second == "ep_ftp":
            p = {"router": P(None, None),
                 "wi": P("model", None, "data"),
                 "wg": P("model", None, "data"),
                 "wo": P("model", "data", None)}
        elif second == "ep_fsdp":
            p = {"router": P(None, None),
                 "wi": P("model", "data", None),
                 "wg": P("model", "data", None),
                 "wo": P("model", None, "data")}
        else:
            p = {"router": P(None, None),
                 "wi": P("model", None, None),
                 "wg": P("model", None, None),
                 "wo": P("model", None, None)}
    else:
        p = {"router": P(None, None),
             "wi": P(None, None, "model"),     # per-expert d_ff TP
             "wg": P(None, None, "model"),
             "wo": P(None, "model", None)}
    if cfg.moe_dense_residual:
        p["dense"] = mlp_pspec(cfg.act, cfg.d_ff_dense, tp)
    return p


class MoE(nn.Module):
    """An MoE layer's parameters, read by name (``p["wi"]``, ``"dense" in
    p``) as ``moe_apply`` reads the reference's dict. On a mesh (``sh``)
    the rank's slices of ``moe_pspec``'s layout."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device, sh: Sharding = NO_MESH):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        full = {"wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
        self.sh = sh
        self.spec = moe_pspec(cfg, sh.spec_tp)
        self.index = {n: sh.index(self.spec[n], shp)
                      for n, shp in full.items()}

        def empty(idx, dt=dtype):
            return nn.Parameter(torch.empty(
                tuple(i.stop - i.start for i in idx), dtype=dt,
                device=device), requires_grad=False)
        self.router = empty((slice(0, d), slice(0, e)), torch.float32)
        self.wi, self.wg, self.wo = (empty(self.index[n])
                                     for n in ("wi", "wg", "wo"))
        if cfg.moe_dense_residual:
            self.dense = mlp_params(d, cfg.d_ff_dense, cfg.act, dtype, device,
                                    sh)
        self.cfg = cfg

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        """He-normal router and experts from ``gen``, drawn into place; a
        rank holding a slice of a bank draws it whole (in ``he_init``'s
        slices) and keeps its part, so the weights are the unsharded
        model's."""
        cfg = self.cfg
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dense_init(gen, d, e, torch.float32, out=self.router)
        for name, shape, fan_in in (("wi", (e, d, f), d),
                                    ("wg", (e, d, f), d),
                                    ("wo", (e, f, d), f)):
            w = self[name]
            he_init(gen, shape, fan_in, w.dtype, out=w,
                    index=self.index[name])
        if "dense" in self:
            init_mlp(self.dense, gen, d, cfg.d_ff_dense, cfg.act, self.sh)

    def banks(self, sum_grad: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``wi``, ``wg``, ``wo`` with their second shard over the data
        axes gathered: this rank's experts whole (or its ``d_ff``
        columns of every expert); ``sum_grad``: each data shard ran its
        own rows, so the gathered gradient sums over the shards."""
        out = []
        for name in ("wi", "wg", "wo"):
            w = self[name]
            for dim, entry in enumerate(self.spec[name]):
                if entry is not None and entry != "model":
                    w = self.sh.gather_data(w, dim, (entry,), sum_grad)
            out.append(w)
        return tuple(out)


def _route(p: Mapping[str, torch.Tensor], x2d: torch.Tensor,
           cfg: ModelConfig, data: Optional[Sharding] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, D) -> (probs (T,k) float32, idx (T,k) int64, aux ()).

    The top k in ``lax.top_k``'s order: descending, the lower expert first
    on a tie (a stable sort), since the dispatch ranks follow it. With
    ``data`` (``x2d`` one data shard's rows of equal shares) the aux loss
    is the whole batch's: the shards' mean fractions and probabilities."""
    logits = x2d.float() @ p["router"]                        # (T, E)
    gates = torch.softmax(logits, dim=-1)
    top_v, top_i = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = torch.softmax(top_v, dim=-1)                      # renormalize
    # switch-style load-balance loss: E * sum_e fraction_e * prob_e
    e = cfg.n_experts
    frac = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    prob = gates.mean(dim=0)
    if data is not None and data.n_data > 1:
        frac = all_reduce(frac, data.data_group()) / data.n_data
        prob = data.mean_data(prob)
    aux = e * torch.sum(frac * prob)
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
        return all_gather(g, 0, ctx.group), None, None, None


class _GatherRows(torch.autograd.Function):
    """Every data shard's ``(t/n, d)`` rows, all-gathered in data order;
    backward keeps this shard's rows of the gradient, which every rank
    holds whole (the loss is the same global one on every rank)."""

    @staticmethod
    def forward(ctx, y, r: int, n: int, group):
        ctx.r, ctx.t_l = r, y.shape[0]
        return all_gather(y, 0, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.r * ctx.t_l:(ctx.r + 1) * ctx.t_l], None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over ``group`` and scales
    it: a weight replicated over the data shards, each of which sees only
    its own tokens (``scale`` undoes the model ranks' copies of them;
    ``group`` None: the scale alone)."""

    @staticmethod
    def forward(ctx, w, group, scale: float):
        ctx.group, ctx.scale = group, scale
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone() if ctx.group is None \
            else all_reduce(g, ctx.group)
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


def _moe_a2a(p: Mapping[str, torch.Tensor], x2d: torch.Tensor,
             cfg: ModelConfig, capacity: int, mesh,
             data_axes: Tuple[str, ...], model_axis: str,
             local_rows: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch with ``all_to_all_single`` along the
    model axis: experts sharded over ``model_axis``, tokens over
    ``data_axes``; ``capacity`` is per (rank, remote rank) lane.
    ``local_rows``: ``x2d`` is already this data shard's rows, and so is
    the output; the router's and the banks' gradients are the rows' part
    (the train step sums them over the data shards)."""
    e, k = cfg.n_experts, cfg.top_k
    m = _axis_size(mesh, model_axis)
    if e % m:
        raise ValueError(f"n_experts must divide model axis ({e} experts "
                         f"over {m})")
    e_local = e // m
    n = math.prod(_axis_size(mesh, a) for a in data_axes)
    t, d = x2d.shape
    if t % n and not local_rows:
        raise ValueError(f"{t} tokens do not split over {n} data shards "
                         f"(the reference's shard_map needs t % n == 0)")
    r = data_index(mesh, data_axes)
    mgroup, dgroup = mesh.get_group(model_axis), data_group(mesh, data_axes)
    x_loc = x2d if local_rows else _Shard.apply(x2d, r, n, dgroup)
    t_l = x_loc.shape[0]
    sum_group = None if local_rows else dgroup
    router = _SumGrad.apply(p["router"], sum_group, 1.0)
    top_p, top_i, aux = _route({"router": router}, x_loc, cfg)
    ranks = _dispatch_ranks(top_i, e)
    # lane layout: (m destination ranks, e_local experts, capacity)
    dest, eloc = top_i // e_local, top_i % e_local
    slot = torch.where(ranks < capacity,
                       dest * (e_local * capacity) + eloc * capacity + ranks,
                       m * e_local * capacity).reshape(-1)
    buf = x_loc.new_zeros((m * e_local * capacity + 1, d))
    buf[slot] = x_loc.repeat_interleave(k, dim=0)             # token-major
    recv = all_to_all(buf[:-1], mgroup)
    # recv: (m, e_local·capacity, d), every model rank's tokens for ours
    xs = recv.reshape(m, e_local, capacity, d).transpose(0, 1) \
        .reshape(e_local, m * capacity, d)
    wi, wg, wo = (_SumGrad.apply(w, sum_group, 1.0 / m)
                  for w in p.banks(sum_grad=local_rows))
    ys = _expert_ffn(wi, wg, wo, xs, cfg.act)
    back = all_to_all(ys.reshape(e_local, m, capacity, d).transpose(0, 1)
                       .reshape(m * e_local * capacity, d), mgroup)
    flat = torch.cat([back, back.new_zeros((1, d))])
    gathered = flat[slot].reshape(t_l, k, d)
    y = torch.sum(gathered * top_p[..., None].to(gathered.dtype), dim=1)
    # the value: data shard 0's aux averaged over the model axis; the
    # gradient: that of the data shards' mean (see the module docstring)
    val = all_reduce(aux, mgroup)
    val = val / m if r == 0 else torch.zeros_like(val)
    val = all_reduce(val, dgroup)
    aux = _AuxOf.apply(aux, val, n)
    return (y if local_rows else _GatherRows.apply(y, r, n, dgroup)), aux


def _moe_sharded(p: "MoE", x2d: torch.Tensor, cfg: ModelConfig,
                 sh: Sharding, local_rows: bool, train: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scatter`` on a mesh: every token routed on every rank; the
    rank's experts (expert-parallel banks) or the rank's ``d_ff`` columns
    of every expert (per-expert TP) run their entries, and the partial
    combines are summed over the model axis. With ``local_rows`` the
    capacity and the ranks are the whole batch's, and with ``train`` the
    aux loss too (see the module's docstring for the gradients)."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    n = sh.n_data if local_rows else 1
    cap = capacity(cfg, t * n)
    top_p, top_i, aux = _route(p, x2d, cfg,
                               sh if local_rows and train else None)
    x2d, top_p = sh.enter(x2d), sh.enter(top_p)
    local = _dispatch_ranks(top_i, e)                         # (T, k)
    ranks = local
    if n > 1 and t * n > EXACT_TOKENS:
        counts = F.one_hot(top_i.reshape(-1), e).sum(0)
        every = all_gather(counts[None], 0, sh.data_group())  # (n, E)
        ranks = local + every[:sh.data_rank].sum(0)[top_i]
    cap_l = min(cap, t)           # a shard's entries of one expert <= t
    wi, wg, wo = p.banks(sum_grad=local_rows)
    ep = divisible(e, sh.spec_tp)
    lo, e_l = (sh.index(P("model"), (e,))[0].start, wi.shape[0]) if ep \
        else (0, e)
    mine = (top_i >= lo) & (top_i < lo + e_l)
    slot = torch.where((ranks < cap) & mine,
                       (top_i - lo) * cap_l + local,
                       e_l * cap_l).reshape(-1)
    buf = x2d.new_zeros((e_l * cap_l + 1, d))
    buf[slot] = x2d.repeat_interleave(k, dim=0)
    ys = _expert_ffn(wi, wg, wo, buf[:-1].reshape(e_l, cap_l, d), cfg.act)
    flat = torch.cat([ys.reshape(e_l * cap_l, d), ys.new_zeros((1, d))])
    gathered = flat[slot].reshape(t, k, d)
    y = torch.sum(gathered * top_p[..., None].to(gathered.dtype), dim=1)
    return sh.reduce(y), aux


def moe_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, impl: str = "scatter", mesh=None,
              data_axes: Tuple[str, ...] = ("data",),
              model_axis: str = "model", sh: Sharding = NO_MESH,
              local_rows: bool = False, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B,S,D), aux_loss ()), the dense residual
    included. ``impl="a2a"`` dispatches over ``mesh`` (tokens over
    ``data_axes``, experts over ``model_axis``; ``p`` holds this rank's
    experts) and needs every rank of the mesh to call it alike. ``sh``:
    the layer's place on a mesh (``scatter`` runs sharded on it);
    ``local_rows``: ``x`` holds this data shard's rows of the batch, not
    all of them (a server or the train step on a mesh); ``train``: the
    sharded ``scatter`` returns the whole batch's aux loss."""
    check_impl(impl, mesh)
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    if impl == "a2a":
        m = _axis_size(mesh, model_axis)
        n_data = math.prod(_axis_size(mesh, a) for a in data_axes)
        t_all = t * n_data if local_rows else t
        t_l = t_all // max(1, n_data)
        cap_l = t_l if t_all <= EXACT_TOKENS else max(
            1, int(cfg.capacity_factor * cfg.top_k * t_l
                   / (cfg.n_experts * max(1, m))))
        y, aux = _moe_a2a(p, x2d, cfg, cap_l, mesh, data_axes, model_axis,
                          local_rows)
    elif sh.tp > 1 or sh.n_data > 1:
        y, aux = _moe_sharded(p, x2d, cfg, sh, local_rows, train)
    else:
        y, aux = _moe_scatter(p, x2d, cfg, capacity(cfg, t))
    y = y.reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(p["dense"], x, cfg.act, sh, cfg.d_ff_dense)
    return y, aux
