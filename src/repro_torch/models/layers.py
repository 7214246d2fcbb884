"""Shared building blocks: RMSNorm, RoPE, gated MLPs, initialisers — the
port of ``repro/models/layers.py``.

Parameters are tensors in the reference's layouts (``(d_in, d_out)``
matrices, ``(vocab, d)`` embeddings). The initialisers draw from an
explicit ``torch.Generator`` on the generator's device; they give other
numbers than ``jax.random`` from the same seed, so parity tests load the
reference's parameters instead (``models.convert``). A tensor of more than ``DRAW_SLICE`` elements is
drawn in slices along its leading axis, so that its float32 draw never
needs a second copy of the whole (arctic-480b's expert banks hold 4.5 G
elements each).

The losses are the reference's: ``cross_entropy`` (token-mean, float32,
z-loss 1e-4, optional mask) and ``chunked_ce``, which never holds more than
one sequence chunk's float32 logits: each chunk is a
``torch.utils.checkpoint`` region, so its logits are recomputed in the
backward pass, as the reference's ``jax.checkpoint`` body does.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["rms_norm", "rope", "mlp_apply", "mlp_params", "init_mlp",
           "he_init", "dense_init", "embed_init", "cross_entropy",
           "chunked_ce", "remat", "DTYPES", "DRAW_SLICE"]

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


def _token_loss(logits: torch.Tensor, labels: torch.Tensor,
                z_loss: float) -> torch.Tensor:
    """Per-token ``logsumexp - gold (+ z_loss · lse²)`` in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean cross entropy in float32 with a z-loss (stabilises large
    vocabularies); with ``mask``, the mean over the masked-in tokens."""
    loss = _token_loss(logits, labels, z_loss)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss.mean()


def chunked_ce(h: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
               n_chunks: int, z_loss: float = 1e-4) -> torch.Tensor:
    """Sequence-chunked cross entropy: the (B, S, V) float32 logits are
    never held whole. h: (B, S, D) final hidden states; unembed: (D, V);
    labels: (B, S). A ragged sequence is padded to ``n_chunks`` equal
    chunks and the padded rows are masked out (they get zero gradient).
    The sum over chunks is divided by ``B · S``."""
    b, s, _ = h.shape
    n_chunks = max(1, min(n_chunks, s))
    pad = (-s) % n_chunks
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    q = (s + pad) // n_chunks
    valid = (torch.arange(s + pad, device=h.device) < s).reshape(n_chunks, q)

    def body(h_i, l_i, v_i):
        loss = _token_loss(h_i @ unembed, l_i, z_loss)
        return torch.where(v_i[None, :], loss, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * q, (c + 1) * q)
        total = total + checkpoint(body, h[:, sl], labels[:, sl], valid[c],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * s)


def remat(fn, enabled: bool):
    """``fn`` as a ``torch.utils.checkpoint`` region when ``enabled`` (its
    activations are recomputed in the backward pass; ``cfg.remat``), else
    ``fn`` itself. Nothing in a model draws random numbers, so the RNG
    state is not saved for the recompute."""
    if not enabled:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)
