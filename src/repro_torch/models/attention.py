"""Grouped-query attention: causal, sliding-window or bidirectional
prefill, single-token decode against full or ring caches, the int8 KV
cache and cross attention — the port of ``repro/models/attention.py`` for
serving: the transformer's layers, Zamba2's shared attention block and
the enc-dec model's encoder, decoder and cross attention.

Self-attention goes through the attention kernels' layout wrappers
(``kernels.ops``), whose route the tensors' device picks: the hand-written
CUDA kernels B3 (prefill) and B4 (decode) on the card, their plain PyTorch
versions on the CPU. The reference's ``cfg.use_pallas`` switch between its
Pallas kernels and an XLA path has no counterpart: the port has one path
and follows the kernels' numerics, fp32 probabilities in P·V (the
reference's XLA path casts them to the value dtype first).

Cross attention (queries against the encoder's frames, another length)
runs outside any kernel, in the reference as in the port:
``_chunked_attention`` is the reference's chunked online softmax in plain
PyTorch, its probabilities cast to the value dtype before P·V as there.

Training takes the reference's XLA path, which is differentiable:
``attn_prefill(..., train=True)`` runs ``_chunked_attention`` with the
reference's triangular (causal) or banded (sliding-window) chunk schedule
instead of B3, which autograd cannot see through. Only the models'
``loss_fn`` passes ``train=True``; serving never does.

Caches are ``{"k", "v"}`` of shape (B, C, K, hd) holding roped keys, or
with ``cfg.kv_dtype == "int8"`` ``{"k", "k_s", "v", "v_s"}``: int8 values
with float32 per-(token, head) scales of shape (B, C, K, 1).
``attn_decode`` writes the new key and value into the cache IN PLACE and
returns the same dict (the reference returns a functional copy), so a
stacked cache's per-layer views update the stack. An int8 cache is
dequantized to the model dtype before B4, as the reference does before its
decode kernel.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import rms_norm, rope

__all__ = ["attn_prefill", "attn_decode", "grow_cache", "init_cache",
           "quantize_kv", "dequantize_kv", "cross_attn_apply", "cross_kv",
           "NEG_INF"]

NEG_INF = -2.0 ** 30   # large-but-finite, as in the reference

Cache = Dict[str, torch.Tensor]


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


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False, window: int = 0,
                       q_chunk: int = 1024, kv_chunk: int = 1024
                       ) -> torch.Tensor:
    """q: (B,S,K,G,hd), k/v: (B,Sk,K,hd) -> float32 (B,S,K,G,hd): the
    reference's ``_chunked_attention``, its fp32 running (max, sum, acc)
    over kv chunks. A query chunk visits only the kv chunks at or below its
    diagonal (``causal``) and within ``window`` of it; masked scores are
    ``NEG_INF``. The probabilities are cast to the value dtype before P·V,
    as the reference's XLA path does."""
    b, s, kh, g, hd = q.shape
    sk = k.shape[1]
    if (causal or window) and sk != s:
        raise ValueError("causal or local attention needs equal q and kv "
                         f"lengths, got {s} and {sk}")
    scale = hd ** -0.5
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, sk)
    outs = []
    for q0 in range(0, s, q_chunk):
        q1 = min(q0 + q_chunk, s)
        qi = q[:, q0:q1]
        qlen = q1 - q0
        m = torch.full((b, kh, g, qlen), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kh, g, qlen), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, qlen, kh, g, hd), dtype=torch.float32,
                          device=q.device)
        hi = q1 if causal else sk
        lo = max(0, q0 - window + 1) if window else 0
        for j in range(lo // kv_chunk, -(-hi // kv_chunk)):
            k0, k1 = j * kv_chunk, min((j + 1) * kv_chunk, sk)
            kj, vj = k[:, k0:k1], v[:, k0:k1]
            sc = torch.einsum("bqkgd,bckd->bkgqc", qi, kj).float() * scale
            if causal or window:
                qpos = torch.arange(q0, q1, device=q.device)[:, None]
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                ok = torch.ones((qlen, k1 - k0), dtype=torch.bool,
                                device=q.device)
                if causal:
                    ok = ok & (kpos <= qpos)
                if window:
                    ok = ok & (kpos > qpos - window)
                sc = torch.where(ok, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            pr = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bqkgd", pr.to(vj.dtype),
                              vj).float()
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        outs.append(acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None])
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def quantize_kv(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: k (..., S, K, hd) -> (int8 of the
    same shape, float32 scales (..., S, K, 1)); rounding half to even, as
    ``jnp.round``."""
    kf = k.float()
    scale = (kf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(kf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def attn_prefill(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig, is_global: bool,
                 with_cache: bool = False, causal: bool = True,
                 train: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Causal (or sliding-window, or bidirectional) self-attention over a
    full sequence. Returns (out (B,S,D), cache or None); a sliding-window
    layer's cache keeps the last ``window`` roped keys and values. B3 runs
    it, or with ``train`` the differentiable ``_chunked_attention``."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, positions, cfg)
    window = 0 if is_global else cfg.window
    attend = _chunked_attention if train else kops.flash_attention
    out = attend(q.reshape(b, s, kh, h // kh, hd), k, v, causal=causal,
                 window=window)
    out = out.reshape(b, s, h, hd).to(x.dtype)
    y = torch.einsum("bshq,hqd->bsd", out, p["wo"])
    cache = None
    if with_cache:
        if window and s > window:
            k, v = k[:, -window:], v[:, -window:]
        if cfg.kv_dtype == "int8":
            qk, sk = quantize_kv(k)
            qv, sv = quantize_kv(v)
            cache = {"k": qk, "k_s": sk, "v": qv, "v_s": sv}
        else:
            cache = {"k": k, "v": v}
    return y, cache


def grow_cache(cache: Cache, cfg: ModelConfig, is_global: bool,
               cache_len: int, prefill_len: int) -> Cache:
    """Grow a prefill-produced cache to its serving capacity: global caches
    are zero-padded to ``cache_len``; ring caches are rolled so slot
    ``p % window`` holds position ``p``. The sequence axis is the third
    from the end (of values and int8 scales alike), so layer-stacked
    caches grow as well."""
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
    eff = cache_len if (is_global or not cfg.window) \
        else min(cfg.window, cache_len)
    shape = (batch, eff, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_s": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cache: Cache, pos: int, cfg: ModelConfig, is_global: bool
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. x: (B,1,D); cache k/v: (B,C,K,hd); pos: the
    number of tokens already in the cache (one for the whole batch).

    The new k/v (quantized, with its scales, in an int8 cache) goes to slot
    ``pos``, or ``pos % C`` in a ring cache (C == window), in place; slots
    [0, valid_len) are attended.
    """
    b = x.shape[0]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg)
    c = cache["k"].shape[1]
    window = 0 if is_global else cfg.window
    ring = bool(window) and window == c
    slot = pos % c if ring else pos
    if "k_s" in cache:
        for name, t in (("k", k_new), ("v", v_new)):
            qt, st = quantize_kv(t)
            cache[name][:, slot] = qt[:, 0]
            cache[f"{name}_s"][:, slot] = st[:, 0]
        k = dequantize_kv(cache["k"], cache["k_s"], x.dtype)
        v = dequantize_kv(cache["v"], cache["v_s"], x.dtype)
    else:
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
        k, v = cache["k"], cache["v"]
    # ring layout: every written slot holds one of the last `window`
    # positions, so slots [0, min(pos+1, c)) are live; linear: [0, pos+1)
    valid_len = min(pos + 1, c) if ring else pos + 1
    o = kops.decode_attention(q.reshape(b, kh, h // kh, hd), k, v,
                              valid_len).to(x.dtype)
    y = torch.einsum("bshq,hqd->bsd", o.reshape(b, 1, h, hd), p["wo"])
    return y, cache


def cross_attn_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                     enc_k: torch.Tensor, enc_v: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,D) queries; enc_k/enc_v: (B,Se,K,hd) precomputed from the
    encoder output (no mask, no RoPE on the cross path)."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dhq->bshq", x, p["wq"]).reshape(b, s, kh,
                                                          h // kh, hd)
    out = _chunked_attention(q, enc_k, enc_v).reshape(b, s, h, hd)
    return torch.einsum("bshq,hqd->bsd", out.to(x.dtype), p["wo"])


def cross_kv(p: Mapping[str, torch.Tensor], enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's cross-attention keys and values (B,Se,K,hd)."""
    return (torch.einsum("bsd,dkq->bskq", enc_out, p["wk"]),
            torch.einsum("bsd,dkq->bskq", enc_out, p["wv"]))
