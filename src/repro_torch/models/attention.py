"""Grouped-query attention: causal or sliding-window prefill, and
single-token decode against full or ring caches — the port of
``repro/models/attention.py`` for serving: the dense transformer's layers
and Zamba2's shared attention block.

Both paths go through the attention kernels' layout wrappers
(``kernels.ops``), whose route the tensors' device picks: the hand-written
CUDA kernels B3 (prefill) and B4 (decode) on the card, their plain PyTorch
versions on the CPU. The reference's ``cfg.use_pallas`` switch between its
Pallas kernels and an XLA path has no counterpart: the port has one path
and follows the kernels' numerics, fp32 probabilities in P·V (the
reference's XLA path casts them to the value dtype first).

Caches are ``{"k", "v"}`` of shape (B, C, K, hd) holding roped keys.
``attn_decode`` writes the new key and value into the cache IN PLACE and
returns the same dict (the reference returns a functional copy), so a
stacked cache's per-layer views update the stack. The int8 KV cache
(``cfg.kv_dtype == "int8"``) and cross attention are not ported yet
(ROADMAP queue A item 12).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import rms_norm, rope

__all__ = ["attn_prefill", "attn_decode", "grow_cache", "init_cache",
           "NEG_INF"]

NEG_INF = -2.0 ** 30   # large-but-finite, as in the reference

Cache = Dict[str, torch.Tensor]


def _no_int8(cfg: ModelConfig) -> None:
    if cfg.kv_dtype == "int8":
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP queue A item 12)")


def _project_qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,K,hd), with qk-norm + RoPE."""
    q = torch.einsum("bsd,dhq->bshq", x, p["wq"])
    k = torch.einsum("bsd,dkq->bskq", x, p["wk"])
    v = torch.einsum("bsd,dkq->bskq", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.head_dim:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_prefill(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig, is_global: bool,
                 with_cache: bool = False, causal: bool = True
                 ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Causal (or sliding-window, or bidirectional) self-attention over a
    full sequence. Returns (out (B,S,D), cache or None); a sliding-window
    layer's cache keeps the last ``window`` roped keys and values."""
    _no_int8(cfg)
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, positions, cfg)
    window = 0 if is_global else cfg.window
    out = kops.flash_attention(q.reshape(b, s, kh, h // kh, hd), k, v,
                               causal=causal, window=window)
    out = out.reshape(b, s, h, hd).to(x.dtype)
    y = torch.einsum("bshq,hqd->bsd", out, p["wo"])
    cache = None
    if with_cache:
        if window and s > window:
            k, v = k[:, -window:], v[:, -window:]
        cache = {"k": k, "v": v}
    return y, cache


def grow_cache(cache: Cache, cfg: ModelConfig, is_global: bool,
               cache_len: int, prefill_len: int) -> Cache:
    """Grow a prefill-produced cache to its serving capacity: global caches
    are zero-padded to ``cache_len``; ring caches are rolled so slot
    ``p % window`` holds position ``p``. The sequence axis is the third
    from the end, so layer-stacked caches grow as well."""
    w = 0 if (is_global or not cfg.window) else cfg.window
    tgt = min(w, cache_len) if w else cache_len

    def fix(a: torch.Tensor) -> torch.Tensor:
        axis = a.dim() - 3
        cur = a.shape[axis]
        if w and prefill_len >= w:
            return torch.roll(a, prefill_len % w, dims=axis)
        if tgt > cur:
            shape = list(a.shape)
            shape[axis] = tgt
            out = a.new_zeros(shape)
            out.narrow(axis, 0, cur).copy_(a)
            return out
        return a

    return {name: fix(a) for name, a in cache.items()}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               is_global: bool, dtype: torch.dtype,
               device: torch.device) -> Cache:
    _no_int8(cfg)
    eff = cache_len if (is_global or not cfg.window) \
        else min(cfg.window, cache_len)
    shape = (batch, eff, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cache: Cache, pos: int, cfg: ModelConfig, is_global: bool
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. x: (B,1,D); cache k/v: (B,C,K,hd); pos: the
    number of tokens already in the cache (one for the whole batch).

    The new k/v goes to slot ``pos``, or ``pos % C`` in a ring cache
    (C == window), in place; slots [0, valid_len) are attended.
    """
    _no_int8(cfg)
    b = x.shape[0]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg)
    c = cache["k"].shape[1]
    window = 0 if is_global else cfg.window
    ring = bool(window) and window == c
    slot = pos % c if ring else pos
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    # ring layout: every written slot holds one of the last `window`
    # positions, so slots [0, min(pos+1, c)) are live; linear: [0, pos+1)
    valid_len = min(pos + 1, c) if ring else pos + 1
    o = kops.decode_attention(q.reshape(b, kh, h // kh, hd), cache["k"],
                              cache["v"], valid_len).to(x.dtype)
    y = torch.einsum("bshq,hqd->bsd", o.reshape(b, 1, h, hd), p["wo"])
    return y, cache
