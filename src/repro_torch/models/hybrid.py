"""Attention-free Mamba2 LM and the Zamba2 hybrid — the port of
``repro/models/hybrid.py`` for serving.

``MambaLM``: embed → N mamba2 blocks → norm → head. ``Zamba2LM``: groups of
``hybrid_attn_every`` mamba2 blocks, each group followed by ONE shared
attention + MLP block (one parameter set reused at every site; each site
keeps its own KV cache), then a tail of ``n_layers % hybrid_attn_every``
mamba2 blocks::

    [ (mamba × k, shared attn) × n_groups, mamba × tail ]

Both heads multiply by ``embed.T`` whatever ``tie_embeddings`` says, as the
reference does (``LMBase``'s tied head). Plain Python loops over the blocks stand in for the
reference's ``scan_blocks``; parameters are built with
``requires_grad=False``, as ``TransformerLM``'s. The methods are
``TransformerLM``'s, so ``launch.serve`` and ``launch.train`` drive every
family alike: ``init(gen)``, ``forward(batch, with_cache, train)``,
``loss_fn(batch)``, ``prefill(batch, cache_len)``,
``decode_step(caches, {"token", "pos"})``, ``init_caches(batch,
cache_len)``. ``loss_fn`` takes the differentiable route
(``forward(train=True)``: the einsum intra-chunk form and the chunked
attention in place of B5 and B3), each block (and shared-attention site) a
``torch.utils.checkpoint`` region when ``cfg.remat``.

State-dict names follow the reference's pytree (``models.convert`` maps it):
``blocks.<i>.{ln, mamba.<name>}`` (MambaLM); ``groups.<g>.<l>.{ln,
mamba.<name>}``, ``tail.<t>.{ln, mamba.<name>}`` and ``shared_attn.{ln1,
attn.<name>, ln2, mlp.<name>}`` (Zamba2LM).

Caches mirror the reference's, stacked over blocks: MambaLM's are
``(conv (L, B, k-1, d_inner + 2N), ssm (L, B, H, P, N))``; Zamba2LM's are
``{"mamba": (conv, ssm) with leading (n_groups, k), "attn": {"k", "v"}
(n_groups, B, C, K, hd), "tail": (conv, ssm) with leading n_tail}``; with
``cfg.kv_dtype == "int8"`` the sites' caches are int8 with float32 scales
``"k_s"``, ``"v_s"`` (``models.attention``).
The prefill writes each block's states and each site's keys and values
into caches allocated once; ``decode_step`` updates them in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import cross_entropy, mlp_apply, remat, rms_norm
from .ssm import init_ssm_state, mamba_decode, mamba_init, mamba_seq
from .transformer import DenseBlock, LMBase, _param

__all__ = ["MambaLM", "Zamba2LM"]

States = Tuple[torch.Tensor, torch.Tensor]


class MambaBlock(nn.Module):
    """Pre-norm residual mamba2 block: ``ln`` and the ``mamba`` dict."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = torch.float32

        def empty(*shape, dt=dtype):
            return _param(torch.empty(shape, dtype=dt, device=device))

        self.ln = _param(torch.zeros(d, dtype=dtype, device=device))
        self.mamba = nn.ParameterDict({
            "wz": empty(d, din), "wx": empty(d, din), "wB": empty(d, n),
            "wC": empty(d, n), "wdt": empty(d, h),
            "conv_w": empty(cfg.ssm_conv, din + 2 * n),
            "conv_b": empty(din + 2 * n), "A_log": empty(h, dt=f32),
            "D": empty(h, dt=f32), "dt_bias": empty(h, dt=f32),
            "norm": empty(din), "wo": empty(din, d)})
        self.cfg = cfg

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        self.ln.zero_()
        for name, t in mamba_init(gen, self.cfg, self.ln.dtype).items():
            self.mamba[name].copy_(t)

    def seq(self, x: torch.Tensor, train: bool = False
            ) -> Tuple[torch.Tensor, States]:
        cfg = self.cfg
        y, st = mamba_seq(self.mamba, rms_norm(x, self.ln, cfg.norm_eps), cfg,
                          train=train)
        return x + y, st

    def step(self, x: torch.Tensor, conv: torch.Tensor, ssm: torch.Tensor
             ) -> torch.Tensor:
        """One decode step; writes the new states into ``conv`` and ``ssm``
        in place."""
        cfg = self.cfg
        y, (c_new, s_new) = mamba_decode(
            self.mamba, rms_norm(x, self.ln, cfg.norm_eps), cfg, conv, ssm)
        conv.copy_(c_new)
        ssm.copy_(s_new)
        return x + y


def _put(stack: States, idx, st: States) -> None:
    """Write one block's (conv, ssm) states into stacked caches."""
    for dst, src in zip(stack, st):
        dst[idx] = src


def _ssm_zeros(cfg: ModelConfig, batch: int, lead: Tuple[int, ...],
               dtype: torch.dtype, device: torch.device) -> States:
    conv, ssm = init_ssm_state(cfg, batch, dtype, device)
    return (conv.expand(*lead, *conv.shape).clone(),
            ssm.expand(*lead, *ssm.shape).clone())


def _lm_loss(model: LMBase, batch: Dict):
    """The SSM and hybrid loss: cross entropy of the tied head's logits
    (``cfg.ce_chunk`` is not read, as in the reference)."""
    tokens = model.tokens(batch)
    h, _ = model.forward({"tokens": tokens[:, :-1]}, train=True)
    loss = cross_entropy(model.logits(h), tokens[:, 1:])
    return loss, {"ce": loss}


class MambaLM(LMBase):
    """cfg.family == "ssm"."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.blocks = nn.ModuleList(MambaBlock(cfg, self.dtype, self.device)
                                    for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "MambaLM":
        """Seeded weights from ``gen`` (on the model's device)."""
        self.init_embed(gen)
        for blk in self.blocks:
            blk.init(gen)
        return self

    def forward(self, batch: Dict, with_cache: bool = False,
                train: bool = False
                ) -> Tuple[torch.Tensor, Optional[States]]:
        """Returns (hidden (B,S,D), stacked (conv, ssm) states or None)."""
        x = self.embed_inputs(batch["tokens"])
        states = self.init_caches(x.shape[0], 0) if with_cache else None
        for i, blk in enumerate(self.blocks):
            x, st = remat(blk.seq, train and self.cfg.remat)(x, train)
            if with_cache:
                _put(states, i, st)
        return x, states

    def loss_fn(self, batch: Dict
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over ``batch["tokens"]`` (B, S+1),
        through the differentiable route: (loss, {"ce": loss})."""
        return _lm_loss(self, batch)

    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, States]:
        """Last-token logits (B,1,V) and the states; ``cache_len`` is
        ignored (the states do not grow), as in the reference."""
        h, states = self.forward(batch, with_cache=True)
        return self.logits(h[:, -1:]), states

    def decode_step(self, caches: States, batch: Dict
                    ) -> Tuple[torch.Tensor, States]:
        """batch: {"token": (B,1) ints, "pos": ignored}. Returns (logits
        (B,1,V), caches), the states updated in place."""
        x = self.embed_inputs(batch["token"])
        conv, ssm = caches
        for i, blk in enumerate(self.blocks):
            x = blk.step(x, conv[i], ssm[i])
        return self.logits(x), caches

    def init_caches(self, batch: int, cache_len: int) -> States:
        return _ssm_zeros(self.cfg, batch, (self.cfg.n_layers,), self.dtype,
                          self.device)


class Zamba2LM(LMBase):
    """cfg.family == "hybrid"."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.hybrid_attn_every <= 0:
            raise ValueError("Zamba2LM needs hybrid_attn_every > 0")
        super().__init__(cfg, device)
        k = cfg.hybrid_attn_every
        self.n_groups, self.n_tail = divmod(cfg.n_layers, k)

        def blocks(n):
            return nn.ModuleList(MambaBlock(cfg, self.dtype, self.device)
                                 for _ in range(n))
        self.groups = nn.ModuleList(blocks(k) for _ in range(self.n_groups))
        self.tail = blocks(self.n_tail)
        self.shared_attn = DenseBlock(cfg, self.dtype, self.device)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Zamba2LM":
        """Seeded weights from ``gen`` (on the model's device)."""
        self.init_embed(gen)
        for group in self.groups:
            for blk in group:
                blk.init(gen)
        for blk in self.tail:
            blk.init(gen)
        self.shared_attn.init(gen)
        return self

    def _site(self, x: torch.Tensor, positions: torch.Tensor,
              with_cache: bool, train: bool):
        """The shared attention + MLP block at one site: (x, its cache or
        None)."""
        cfg, p = self.cfg, self.shared_attn
        h, kv = attn.attn_prefill(
            p.attn, rms_norm(x, p.ln1, cfg.norm_eps), positions, cfg, True,
            with_cache, train=train)
        x = x + h
        return x + mlp_apply(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps),
                             cfg.act), kv

    def forward(self, batch: Dict, with_cache: bool = False,
                cache_len: Optional[int] = None, train: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Returns (hidden (B,S,D), caches or None). The caches hold every
        mamba block's states and every site's KV cache of
        ``max(cache_len, S)`` slots, the prompt's keys and values first and
        zeros after (the reference grows its caches after the prefill)."""
        x = self.embed_inputs(batch["tokens"])
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        caches = self.init_caches(b, max(cache_len or s, s)) \
            if with_cache else None
        on = train and self.cfg.remat
        site = remat(self._site, on)
        for g, group in enumerate(self.groups):
            for l, blk in enumerate(group):
                x, st = remat(blk.seq, on)(x, train)
                if with_cache:
                    _put(caches["mamba"], (g, l), st)
            x, kv = site(x, positions, with_cache, train)
            if with_cache:
                for n, t in kv.items():
                    caches["attn"][n][g, :, :s] = t
        for t, blk in enumerate(self.tail):
            x, st = remat(blk.seq, on)(x, train)
            if with_cache:
                _put(caches["tail"], t, st)
        return x, caches

    def loss_fn(self, batch: Dict
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over ``batch["tokens"]`` (B, S+1),
        through the differentiable route: (loss, {"ce": loss})."""
        return _lm_loss(self, batch)

    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Last-token logits (B,1,V) and the caches, every site's KV cache
        holding ``cache_len`` slots when given."""
        h, caches = self.forward(batch, with_cache=True, cache_len=cache_len)
        return self.logits(h[:, -1:]), caches

    def decode_step(self, caches: Dict, batch: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
        """batch: {"token": (B,1) ints, "pos": int}. Returns (logits
        (B,1,V), caches), the caches updated in place."""
        cfg, p = self.cfg, self.shared_attn
        pos = int(batch["pos"])
        x = self.embed_inputs(batch["token"])
        conv, ssm = caches["mamba"]
        for g, group in enumerate(self.groups):
            for l, blk in enumerate(group):
                x = blk.step(x, conv[g, l], ssm[g, l])
            site = {n: t[g] for n, t in caches["attn"].items()}
            h, _ = attn.attn_decode(p.attn, rms_norm(x, p.ln1, cfg.norm_eps),
                                    site, pos, cfg, True)
            x = x + h
            x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps),
                              cfg.act)
        if self.n_tail:
            conv, ssm = caches["tail"]
            for t, blk in enumerate(self.tail):
                x = blk.step(x, conv[t], ssm[t])
        return self.logits(x), caches

    def init_caches(self, batch: int, cache_len: int) -> Dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        one = attn.init_cache(cfg, batch, cache_len, True, dt, dev)
        caches = {"mamba": _ssm_zeros(cfg, batch, (self.n_groups,
                                                   cfg.hybrid_attn_every),
                                      dt, dev),
                  "attn": {n: t.expand(self.n_groups, *t.shape).clone()
                           for n, t in one.items()}}
        if self.n_tail:
            caches["tail"] = _ssm_zeros(cfg, batch, (self.n_tail,), dt, dev)
        return caches
