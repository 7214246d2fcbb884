"""Shared building blocks: RMSNorm, RoPE, gated MLPs, initialisers — the
port of ``repro/models/layers.py``.

Parameters are tensors in the reference's layouts (``(d_in, d_out)``
matrices, ``(vocab, d)`` embeddings). The initialisers draw from an
explicit ``torch.Generator`` on the generator's device; they give other
numbers than ``jax.random`` from the same seed, so parity tests load the
reference's parameters instead (``models.convert``). A tensor of more than ``DRAW_SLICE`` elements is
drawn in slices along its leading axis, so that its float32 draw never
needs a second copy of the whole (arctic-480b's expert banks hold 4.5 G
elements each). The training helpers (``cross_entropy``, ``chunked_ce``)
come with the training slice.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["rms_norm", "rope", "mlp_apply", "mlp_params", "init_mlp",
           "he_init", "dense_init", "embed_init", "DTYPES", "DRAW_SLICE"]

#: ``ModelConfig.dtype`` names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: elements of one float32 draw at most (1 GiB)
DRAW_SLICE = 1 << 28


def he_init(gen: torch.Generator, shape: Tuple[int, ...],
            fan_in: Optional[int] = None,
            dtype: torch.dtype = torch.float32,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in float32 on ``gen``'s device, cast to
    ``dtype`` (or written into ``out``, of ``shape``), in slices of at most
    ``DRAW_SLICE`` elements along the leading axis."""
    fan_in = fan_in or shape[0]
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, DRAW_SLICE // max(1, math.prod(shape[1:])))
    for r in range(0, shape[0], rows):
        n = min(rows, shape[0] - r)
        x = torch.randn((n, *shape[1:]), generator=gen, dtype=torch.float32,
                        device=gen.device)
        out[r:r + n].copy_(x.mul_(1.0 / math.sqrt(fan_in)))
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    return he_init(gen, (d_in, d_out), d_in, dtype, out)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    return he_init(gen, (vocab, d), d, dtype, out)


def mlp_params(d: int, ff: int, act: str, dtype: torch.dtype,
               device: torch.device) -> nn.ParameterDict:
    """An MLP's ``{wi, wo[, wg]}`` in the reference's layouts, allocated,
    not initialised (``init_mlp`` fills them)."""
    def empty(*shape):
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)
    p = {"wi": empty(d, ff), "wo": empty(ff, d)}
    if act in ("swiglu", "geglu"):
        p["wg"] = empty(d, ff)
    return nn.ParameterDict(p)


@torch.no_grad()
def init_mlp(p: nn.ParameterDict, gen: torch.Generator) -> None:
    """He-normal ``wi``, ``wo`` and ``wg`` from ``gen``, in that order."""
    for w in p.values():
        dense_init(gen, w.shape[0], w.shape[1], w.dtype, out=w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + scale`` (scales start at zero),
    cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-split rotary embedding with float32 angles. x: (..., seq,
    heads, head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq      # (..., s, half)
    cos = torch.cos(angles)[..., :, None, :]              # over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, act: str
              ) -> torch.Tensor:
    """swiglu / geglu (tanh GELU) gated MLP, or an ungated tanh-GELU MLP."""
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif act == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])
    elif act == "gelu":
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise ValueError(f"unknown act {act}")
    return h @ p["wo"]
