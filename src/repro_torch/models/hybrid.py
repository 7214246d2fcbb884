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

On a device mesh (``mesh=``) both hold the rank's slices of
``param_pspecs()`` (the reference's: ``mamba_pspec`` per block, and for
Zamba2 the shared block's attention and MLP specs), run B5 on the rank's
``ssm_heads / tp`` heads and the shared attention's B3 / B4 on its heads
(``models.ssm``, ``models.attention``), and split a served batch's rows
over the data axes as ``TransformerLM`` does (a batch of 1: replicated,
Zamba2's sites keeping the shard's cache slots, the Mamba2 states whole;
``loss_fn(local_rows=True)`` for the mesh train step).
``cache_pspecs`` are the reference's; a rank's conv states hold its x
channels and the whole B and C (``models.ssm``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import (NO_MESH, P, Sharding, cross_entropy, divisible,
                     mlp_pspec, remat, rms_norm)
from .ssm import (init_ssm_state, mamba_decode, mamba_init, mamba_pspec,
                  mamba_seq, mamba_shapes, mamba_sharding, ssm_state_pspec)
from .transformer import (DenseBlock, LMBase, _module_specs, _param,
                          flat_specs, with_leading)

__all__ = ["MambaLM", "Zamba2LM"]

States = Tuple[torch.Tensor, torch.Tensor]


class MambaBlock(nn.Module):
    """Pre-norm residual mamba2 block: ``ln`` and the ``mamba`` dict."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device, sh: Sharding = NO_MESH):
        super().__init__()
        spec = mamba_pspec(cfg, sh.spec_tp)
        f32 = ("A_log", "D", "dt_bias")
        self.ln = _param(torch.zeros(cfg.d_model, dtype=dtype, device=device))
        self.mamba = nn.ParameterDict({
            n: _param(torch.empty(sh.local_shape(spec[n], shape),
                                  dtype=torch.float32 if n in f32 else dtype,
                                  device=device))
            for n, shape in mamba_shapes(cfg).items()})
        self.cfg, self.sh = cfg, sh
        self.msh = mamba_sharding(cfg, sh)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        self.ln.zero_()
        mamba_init(self.mamba, gen, self.cfg, self.sh)

    def seq(self, x: torch.Tensor, train: bool = False
            ) -> Tuple[torch.Tensor, States]:
        cfg = self.cfg
        y, st = mamba_seq(self.mamba, rms_norm(x, self.ln, cfg.norm_eps), cfg,
                          train=train, sh=self.msh)
        return x + y, st

    def step(self, x: torch.Tensor, conv: torch.Tensor, ssm: torch.Tensor
             ) -> torch.Tensor:
        """One decode step; writes the new states into ``conv`` and ``ssm``
        in place."""
        cfg = self.cfg
        y, (c_new, s_new) = mamba_decode(
            self.mamba, rms_norm(x, self.ln, cfg.norm_eps), cfg, conv, ssm,
            self.msh)
        conv.copy_(c_new)
        ssm.copy_(s_new)
        return x + y


def _put(stack: States, idx, st: States) -> None:
    """Write one block's (conv, ssm) states into stacked caches."""
    for dst, src in zip(stack, st):
        dst[idx] = src


def _ssm_zeros(cfg: ModelConfig, batch: int, lead: Tuple[int, ...],
               dtype: torch.dtype, device: torch.device,
               sh: Sharding = NO_MESH) -> States:
    conv, ssm = init_ssm_state(cfg, batch, dtype, device,
                               mamba_sharding(cfg, sh))
    return (conv.expand(*lead, *conv.shape).clone(),
            ssm.expand(*lead, *ssm.shape).clone())


def _lm_loss(model: LMBase, batch: Dict, local_rows: bool = False):
    """The SSM and hybrid loss: cross entropy of the tied head's logits
    (``cfg.ce_chunk`` is not read, as in the reference); ``local_rows``:
    the data shards' mean of their rows' losses (``TransformerLM.
    loss_fn``)."""
    tokens = model.tokens(batch)
    h, _ = model.forward({"tokens": tokens[:, :-1]}, train=True)
    loss = cross_entropy(model.logits(h), tokens[:, 1:])
    if local_rows:
        loss = model.sh.mean_data(loss)
    return loss, {"ce": loss}


def _state_specs(lm: LMBase, shard_seq: bool) -> Tuple[P, P]:
    batch_axes = lm.data_axes if len(lm.data_axes) > 1 else lm.data_axes[0]
    return ssm_state_pspec(batch_axes, replicate_batch=shard_seq)


class MambaLM(LMBase):
    """cfg.family == "ssm"."""

    def __init__(self, cfg: ModelConfig, device=None, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",)):
        super().__init__(cfg, device, mesh, data_axes)
        self.blocks = nn.ModuleList(
            MambaBlock(cfg, self.dtype, self.device, self.sh)
            for _ in range(cfg.n_layers))

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's specs under the state dict's names."""
        block = {"ln": P(None),
                 "mamba": mamba_pspec(self.cfg, self.sh.spec_tp)}
        return {"embed": self._embed_spec(), "final_norm": P(None),
                **_module_specs(self, MambaBlock, block)}

    def cache_pspecs(self, shard_seq: bool) -> Tuple[P, P]:
        return with_leading(_state_specs(self, shard_seq), 1)

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
        """Returns (hidden (B,S,D), stacked (conv, ssm) states or None), of
        the rows given (``prefill`` gives this data shard's)."""
        x = self.embed_inputs(batch["tokens"])
        states = self._zero_states(x.shape[0]) if with_cache else None
        for i, blk in enumerate(self.blocks):
            x, st = remat(blk.seq, train and self.cfg.remat)(x, train)
            if with_cache:
                _put(states, i, st)
        return x, states

    def loss_fn(self, batch: Dict, local_rows: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over ``batch["tokens"]`` (B, S+1),
        through the differentiable route: (loss, {"ce": loss});
        ``local_rows`` as ``TransformerLM.loss_fn``."""
        return _lm_loss(self, batch, local_rows)

    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, States]:
        """Last-token logits (B,1,V) and the states; ``cache_len`` is
        ignored (the states do not grow), as in the reference. A batch of
        1 over several data shards runs replicated (so do its states)."""
        rows = self.rows(batch)
        h, states = self.forward(self.split_batch(batch), with_cache=True)
        return self.sh.gather_rows(self.logits(h[:, -1:]), rows), states

    def decode_step(self, caches: States, batch: Dict
                    ) -> Tuple[torch.Tensor, States]:
        """batch: {"token": (B,1) ints, "pos": ignored}. Returns (logits
        (B,1,V), caches), the states updated in place."""
        rows = int(batch["token"].shape[0])
        x = self.embed_inputs(self.sh.split_rows(batch["token"]))
        conv, ssm = caches
        for i, blk in enumerate(self.blocks):
            x = blk.step(x, conv[i], ssm[i])
        return self.sh.gather_rows(self.logits(x), rows), caches

    def _zero_states(self, rows: int) -> States:
        return _ssm_zeros(self.cfg, rows, (self.cfg.n_layers,), self.dtype,
                          self.device, self.sh)

    def init_caches(self, batch: int, cache_len: int) -> States:
        """Zero states for a batch of ``batch`` (on a mesh this data
        shard's rows, the rank's heads and channels)."""
        return self._zero_states(self.sh.local_rows(batch))


class Zamba2LM(LMBase):
    """cfg.family == "hybrid"."""

    def __init__(self, cfg: ModelConfig, device=None, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",)):
        if cfg.hybrid_attn_every <= 0:
            raise ValueError("Zamba2LM needs hybrid_attn_every > 0")
        super().__init__(cfg, device, mesh, data_axes)
        k = cfg.hybrid_attn_every
        self.n_groups, self.n_tail = divmod(cfg.n_layers, k)

        def blocks(n):
            return nn.ModuleList(MambaBlock(cfg, self.dtype, self.device,
                                            self.sh) for _ in range(n))
        self.groups = nn.ModuleList(blocks(k) for _ in range(self.n_groups))
        self.tail = blocks(self.n_tail)
        self.shared_attn = DenseBlock(cfg, self.dtype, self.device, self.sh)

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's specs under the state dict's names."""
        cfg, tp = self.cfg, self.sh.spec_tp
        block = {"ln": P(None), "mamba": mamba_pspec(cfg, tp)}
        shared = {"ln1": P(None), "attn": attn.attn_pspec(cfg, tp),
                  "ln2": P(None), "mlp": mlp_pspec(cfg.act, cfg.d_ff, tp)}
        return {"embed": self._embed_spec(), "final_norm": P(None),
                **_module_specs(self, MambaBlock, block),
                **flat_specs(shared, "shared_attn.")}

    def cache_pspecs(self, shard_seq: bool) -> Dict:
        cfg = self.cfg
        batch_axes = self.data_axes if len(self.data_axes) > 1 \
            else self.data_axes[0]
        ssm_spec = _state_specs(self, shard_seq)
        kv_ok = divisible(cfg.n_kv_heads, self.sh.spec_tp)
        a_spec = attn.cache_pspec(batch_axes, shard_seq, kv_ok,
                                  quantized=cfg.kv_dtype == "int8")
        caches = {"mamba": with_leading(ssm_spec, 2),
                  "attn": with_leading(a_spec, 1)}
        if self.n_tail:
            caches["tail"] = with_leading(ssm_spec, 1)
        return caches

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
            with_cache, train=train, sh=self.sh)
        x = x + h
        return x + p.ffn(x)[0], kv

    def forward(self, batch: Dict, with_cache: bool = False,
                cache_len: Optional[int] = None, train: bool = False,
                seq: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Returns (hidden (B,S,D), caches or None). The caches hold every
        mamba block's states and every site's KV cache of
        ``max(cache_len, S)`` slots, the prompt's keys and values first and
        zeros after (the reference grows its caches after the prefill);
        with ``seq`` each site keeps the data shard's slots of it."""
        x = self.embed_inputs(batch["tokens"])
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        slots = max(cache_len or s, s)
        caches = self._zero_caches(b, slots, seq) if with_cache else None
        on = train and self.cfg.remat
        site = remat(self._site, on)
        for g, group in enumerate(self.groups):
            for l, blk in enumerate(group):
                x, st = remat(blk.seq, on)(x, train)
                if with_cache:
                    _put(caches["mamba"], (g, l), st)
            x, kv = site(x, positions, with_cache, train)
            if with_cache:
                for n, t in attn.grow_cache(kv, self.cfg, True, slots, s,
                                            self.sh, seq).items():
                    caches["attn"][n][g] = t
        for t, blk in enumerate(self.tail):
            x, st = remat(blk.seq, on)(x, train)
            if with_cache:
                _put(caches["tail"], t, st)
        return x, caches

    def loss_fn(self, batch: Dict, local_rows: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over ``batch["tokens"]`` (B, S+1),
        through the differentiable route: (loss, {"ce": loss});
        ``local_rows`` as ``TransformerLM.loss_fn``."""
        return _lm_loss(self, batch, local_rows)

    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Last-token logits (B,1,V) and the caches, every site's KV cache
        holding ``cache_len`` slots when given (a batch of 1 over several
        data shards: replicated, each site keeping the shard's slots)."""
        rows = self.rows(batch)
        h, caches = self.forward(self.split_batch(batch), with_cache=True,
                                 cache_len=cache_len,
                                 seq=self.sh.seq_parallel(rows))
        return self.sh.gather_rows(self.logits(h[:, -1:]), rows), caches

    def decode_step(self, caches: Dict, batch: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
        """batch: {"token": (B,1) ints, "pos": int}. Returns (logits
        (B,1,V), caches), the caches updated in place."""
        cfg, p = self.cfg, self.shared_attn
        pos = int(batch["pos"])
        rows = int(batch["token"].shape[0])
        seq = self.sh.seq_parallel(rows)
        x = self.embed_inputs(self.sh.split_rows(batch["token"]))
        conv, ssm = caches["mamba"]
        for g, group in enumerate(self.groups):
            for l, blk in enumerate(group):
                x = blk.step(x, conv[g, l], ssm[g, l])
            site = {n: t[g] for n, t in caches["attn"].items()}
            h, _ = attn.attn_decode(p.attn, rms_norm(x, p.ln1, cfg.norm_eps),
                                    site, pos, cfg, True, self.sh, seq=seq)
            x = x + h
            x = x + p.ffn(x)[0]
        if self.n_tail:
            conv, ssm = caches["tail"]
            for t, blk in enumerate(self.tail):
                x = blk.step(x, conv[t], ssm[t])
        return self.sh.gather_rows(self.logits(x), rows), caches

    def init_caches(self, batch: int, cache_len: int) -> Dict:
        """Zero caches for a batch of ``batch`` (on a mesh this data
        shard's rows, the rank's heads and channels; a batch of 1 over
        several data shards: the shard's slots)."""
        return self._zero_caches(self.sh.local_rows(batch), cache_len,
                                 self.sh.seq_parallel(batch))

    def _zero_caches(self, rows: int, cache_len: int,
                     seq: bool = False) -> Dict:
        cfg, dt, dev, sh = self.cfg, self.dtype, self.device, self.sh
        one = attn.init_cache(cfg, rows, cache_len, True, dt, dev, sh, seq)
        caches = {"mamba": _ssm_zeros(cfg, rows, (self.n_groups,
                                                  cfg.hybrid_attn_every),
                                      dt, dev, sh),
                  "attn": {n: t.expand(self.n_groups, *t.shape).clone()
                           for n, t in one.items()}}
        if self.n_tail:
            caches["tail"] = _ssm_zeros(cfg, rows, (self.n_tail,), dt, dev,
                                        sh)
        return caches
