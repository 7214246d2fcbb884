"""Mixture-of-Experts FFN (mixtral-style top-k; arctic adds a dense
residual branch) — the port of ``repro/models/moe.py`` with its
``scatter`` dispatch.

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
``torch.bmm`` (cuBLAS on the card), the dispatch is indexing. The
reference's ``a2a`` dispatch (``shard_map`` + ``all_to_all`` over a mesh)
waits for ROADMAP queue A item 13.

Parameters, in the reference's layouts: ``router (d, E)`` float32, ``wi``,
``wg (E, d, F)``, ``wo (E, F, d)``, and for arctic ``dense.{wi, wg, wo}``.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import dense_init, he_init, init_mlp, mlp_apply, mlp_params

__all__ = ["MoE", "moe_apply", "capacity", "check_impl", "EXACT_TOKENS"]

#: tokens up to which routing keeps every entry (capacity = tokens)
EXACT_TOKENS = 8192


def check_impl(impl: str) -> None:
    """The port dispatches with ``scatter`` only."""
    if impl == "a2a":
        raise NotImplementedError(
            "moe_impl='a2a' (expert parallelism over a mesh with "
            "all_to_all) waits for ROADMAP queue A item 13")
    if impl != "scatter":
        raise ValueError(f"unknown moe_impl {impl!r}")


class MoE(nn.Module):
    """An MoE layer's parameters, read by name (``p["wi"]``, ``"dense" in
    p``) as ``moe_apply`` reads the reference's dict."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.router = empty(d, e, dt=torch.float32)
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
        """He-normal router and experts from ``gen``, drawn into place."""
        d, f = self.cfg.d_model, self.cfg.d_ff
        dense_init(gen, d, self.cfg.n_experts, torch.float32, out=self.router)
        for w, fan_in in ((self.wi, d), (self.wg, d), (self.wo, f)):
            he_init(gen, tuple(w.shape), fan_in, w.dtype, out=w)
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


def moe_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, impl: str = "scatter"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B,S,D), aux_loss ()), the dense residual
    included."""
    check_impl(impl)
    b, s, d = x.shape
    t = b * s
    y, aux = _moe_scatter(p, x.reshape(t, d), cfg, capacity(cfg, t))
    y = y.reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(p["dense"], x, cfg.act)
    return y, aux
