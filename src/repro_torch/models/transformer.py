"""Decoder-only transformer LM for the dense family with a uniform
attention pattern (every layer global, or every layer sliding-window) —
the port of ``repro/models/transformer.py`` for serving.

``TransformerLM`` is an ``nn.Module`` that owns its parameters, in the
reference's layouts: ``embed (vocab, d)``, ``final_norm (d,)`` and per
layer ``blocks.<i>.{ln1, ln2}``, ``blocks.<i>.attn.{wq (d,h,hd), wk, wv
(d,k,hd), wo (h,hd,d), q_norm, k_norm}``, ``blocks.<i>.mlp.{wi, wg, wo}``
(``models.convert`` maps the reference's layer-stacked pytree onto these
names). A plain Python loop over the layers stands in for the reference's
``lax.scan``. Parameters do not require gradients: this slice serves.
``LMBase`` holds what every family's LM shares (embedding, final norm,
tied head); ``DenseBlock`` is also Zamba2's shared attention block.

Caches are layer-stacked as in the reference, ``{"k", "v"}`` of shape
(L, B, C, K, hd); ``decode_step`` writes each layer's new key and value
into them in place. The periodic local:global groups (gemma3), MoE and VLM
raise NotImplementedError (ROADMAP queue A item 12).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import attention as attn
from .layers import DTYPES, dense_init, embed_init, mlp_apply, rms_norm

__all__ = ["TransformerLM", "LMBase"]

Caches = Dict[str, torch.Tensor]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseBlock(nn.Module):
    """One pre-norm attention + MLP layer; parameters allocated, not
    initialised (``init`` fills them)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, h, k, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff)

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dtype, device=device))

        def zeros(n):
            return _param(torch.zeros(n, dtype=dtype, device=device))

        self.ln1, self.ln2 = zeros(d), zeros(d)
        a = {"wq": empty(d, h, hd), "wk": empty(d, k, hd),
             "wv": empty(d, k, hd), "wo": empty(h, hd, d)}
        if cfg.qk_norm:
            a["q_norm"], a["k_norm"] = zeros(hd), zeros(hd)
        self.attn = nn.ParameterDict(a)
        m = {"wi": empty(d, ff), "wo": empty(ff, d)}
        if cfg.act in ("swiglu", "geglu"):
            m["wg"] = empty(d, ff)
        self.mlp = nn.ParameterDict(m)
        self.cfg = cfg

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        """He-normal projections from ``gen``, zero norm scales."""
        cfg = self.cfg
        d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = self.ln1.dtype
        self.ln1.zero_()
        self.ln2.zero_()
        a = self.attn
        a["wq"].copy_(dense_init(gen, d, h * hd, dt).reshape(d, h, hd))
        a["wk"].copy_(dense_init(gen, d, k * hd, dt).reshape(d, k, hd))
        a["wv"].copy_(dense_init(gen, d, k * hd, dt).reshape(d, k, hd))
        a["wo"].copy_(dense_init(gen, h * hd, d, dt).reshape(h, hd, d))
        if cfg.qk_norm:
            a["q_norm"].zero_()
            a["k_norm"].zero_()
        for name in self.mlp:
            w = self.mlp[name]
            w.copy_(dense_init(gen, w.shape[0], w.shape[1], dt))


class LMBase(nn.Module):
    """What every family's LM shares: ``embed (vocab, d)`` and
    ``final_norm (d,)`` in the model dtype on the model's device (``cuda``
    unless told), the scaled embedding lookup and the tied head."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.embed = _param(torch.empty((cfg.vocab, cfg.d_model),
                                        dtype=self.dtype, device=self.device))
        self.final_norm = _param(torch.zeros(cfg.d_model, dtype=self.dtype,
                                             device=self.device))

    def init_embed(self, gen: torch.Generator) -> None:
        self.embed.copy_(embed_init(gen, self.cfg.vocab, self.cfg.d_model,
                                    self.dtype))
        self.final_norm.zero_()

    def embed_inputs(self, tok) -> torch.Tensor:
        """Token ids (any int array) -> embeddings times d_model**0.5, the
        scale cast to the model dtype as the reference does."""
        x = self.embed[torch.as_tensor(tok, device=self.device).long()]
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype,
                                device=self.device)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return rms_norm(h, self.final_norm, self.cfg.norm_eps) @ self.embed.T


class TransformerLM(LMBase):
    """cfg.family == "dense" with ``local_global_period == 0``."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP queue A "
                f"item 12): the port serves the dense family")
        if cfg.local_global_period:
            raise NotImplementedError(
                "the periodic local:global group scan (gemma3) is not ported "
                "yet (ROADMAP queue A item 12)")
        if cfg.kv_dtype == "int8":
            raise NotImplementedError(
                "the int8 KV cache is not ported yet (ROADMAP queue A "
                "item 12)")
        super().__init__(cfg, device)
        self.is_global = cfg.window == 0
        dev, dt = self.device, self.dtype
        self.blocks = nn.ModuleList(DenseBlock(cfg, dt, dev)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.unembed = _param(torch.empty((cfg.d_model, cfg.vocab),
                                              dtype=dt, device=dev))

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "TransformerLM":
        """He-normal weights and embeddings from ``gen`` (on the model's
        device), zero norm scales."""
        cfg = self.cfg
        self.init_embed(gen)
        for blk in self.blocks:
            blk.init(gen)
        if not cfg.tie_embeddings:
            self.unembed.copy_(embed_init(gen, cfg.vocab, cfg.d_model,
                                          self.dtype).T)
        return self

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return super().logits(h)
        return rms_norm(h, self.final_norm, self.cfg.norm_eps) @ self.unembed

    # ----------------------------------------------------------- seq path
    def forward(self, batch: Dict, with_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """Returns (hidden (B,S,D), layer-stacked caches or None)."""
        cfg = self.cfg
        x = self.embed_inputs(batch["tokens"])
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        caches = None
        for i, blk in enumerate(self.blocks):
            h, c = attn.attn_prefill(
                blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), positions, cfg,
                self.is_global, with_cache)
            x = x + h
            x = x + mlp_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps),
                              cfg.act)
            if with_cache:
                if caches is None:
                    caches = {n: t.new_empty((cfg.n_layers, *t.shape))
                              for n, t in c.items()}
                for n, t in c.items():
                    caches[n][i] = t
        return x, caches

    # ------------------------------------------------------------ serving
    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """Last-token logits (B,1,V) and the caches, grown to
        ``cache_len`` when given."""
        h, caches = self.forward(batch, with_cache=True)
        logits = self.logits(h[:, -1:])
        if cache_len is not None:
            caches = attn.grow_cache(caches, self.cfg, self.is_global,
                                     cache_len, h.shape[1])
        return logits, caches

    def decode_step(self, caches: Caches, batch: Dict
                    ) -> Tuple[torch.Tensor, Caches]:
        """batch: {"token": (B,1) ints, "pos": int}. Returns (logits
        (B,1,V), caches), the caches updated in place."""
        cfg = self.cfg
        pos = int(batch["pos"])
        x = self.embed_inputs(batch["token"])
        for i, blk in enumerate(self.blocks):
            layer = {n: t[i] for n, t in caches.items()}
            h, _ = attn.attn_decode(
                blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), layer, pos,
                cfg, self.is_global)
            x = x + h
            x = x + mlp_apply(blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps),
                              cfg.act)
        return self.logits(x), caches

    # ------------------------------------------------------------- caches
    def init_caches(self, batch: int, cache_len: int) -> Caches:
        one = attn.init_cache(self.cfg, batch, cache_len, self.is_global,
                              self.dtype, self.device)
        return {n: t.expand(self.cfg.n_layers, *t.shape).clone()
                for n, t in one.items()}
