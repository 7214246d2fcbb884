"""Decoder-only transformer LM covering the dense, MoE and VLM families —
the port of ``repro/models/transformer.py`` for serving.

``TransformerLM`` is an ``nn.Module`` that owns its parameters, in the
reference's layouts: ``embed (vocab, d)``, ``final_norm (d,)``, per layer
``{ln1, ln2}``, ``attn.{wq (d,h,hd), wk, wv (d,k,hd), wo (h,hd,d), q_norm,
k_norm}`` and either ``mlp.{wi, wg, wo}`` or, for the MoE family, ``moe.
{router, wi, wg, wo[, dense.*]}`` (``models.moe``); ``unembed`` when the
head is untied and ``vision_proj (d, d)`` for the VLM, whose vision
embeddings, projected, prefix the token embeddings.

Layer stacking follows the reference (``models.convert`` maps its pytree
onto these names):
  * uniform patterns (every layer global, or every layer sliding-window as
    mixtral): ``blocks.<i>``;
  * periodic local:global patterns (gemma3: 5 local + 1 global):
    ``blocks.<g>.<l>`` for ``n_layers // period`` whole periods, layer l
    of a period global iff ``(l + 1) % period == 0``, then ``tail.<t>``,
    the ``n_layers % period`` leftover layers, all local.
Plain Python loops over the layers stand in for the reference's
``lax.scan``. Parameters are built with ``requires_grad=False``, for
serving; the train builder (``launch.steps.make_train_objects``) turns
gradients on. ``loss_fn`` is the only caller of ``forward(train=True)``,
the differentiable route (``attention._chunked_attention`` in place of
B3), each block a ``torch.utils.checkpoint`` region when ``cfg.remat``.
``LMBase`` holds what every family's LM shares (embedding, final norm,
tied head); ``DenseBlock`` is also Zamba2's shared attention block and the
enc-dec model's encoder block.

Caches nest as the reference's: uniform models keep ``{"k", "v"}`` (with
``cfg.kv_dtype == "int8"`` also ``"k_s"``, ``"v_s"``) stacked over layers,
(L, B, C, K, hd); periodic models keep ``{"groups": {"local": (G, P-1, B,
C_w, K, hd), "global": (G, B, C, K, hd)}, "tail": (n_tail, B, C_w, K,
hd)}`` of such dicts, where a local layer's ring holds ``C_w = min(window,
C)`` slots. ``decode_step`` writes each layer's new key and value into
them in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import attention as attn
from . import moe as moe_mod
from .layers import (DTYPES, chunked_ce, cross_entropy, dense_init,
                     embed_init, init_mlp, mlp_apply, mlp_params, remat,
                     rms_norm)

__all__ = ["TransformerLM", "LMBase", "DenseBlock"]

Caches = Dict[str, object]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseBlock(nn.Module):
    """One pre-norm attention + MLP (or MoE) layer; parameters allocated,
    not initialised (``init`` fills them)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device,
                 experts: Optional[Tuple[int, int]] = None):
        super().__init__()
        d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

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
        if cfg.n_experts:
            self.moe = moe_mod.MoE(cfg, dtype, device, experts)
        else:
            self.mlp = mlp_params(d, cfg.d_ff, cfg.act, dtype, device)
        self.cfg = cfg

    @staticmethod
    @torch.no_grad()
    def init_attn(a: nn.ParameterDict, cfg: ModelConfig,
                  gen: torch.Generator) -> None:
        """He-normal projections from ``gen``, zero qk-norm scales."""
        d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = a["wq"].dtype
        a["wq"].copy_(dense_init(gen, d, h * hd, dt).reshape(d, h, hd))
        a["wk"].copy_(dense_init(gen, d, k * hd, dt).reshape(d, k, hd))
        a["wv"].copy_(dense_init(gen, d, k * hd, dt).reshape(d, k, hd))
        a["wo"].copy_(dense_init(gen, h * hd, d, dt).reshape(h, hd, d))
        if cfg.qk_norm:
            a["q_norm"].zero_()
            a["k_norm"].zero_()

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        """He-normal projections from ``gen``, zero norm scales."""
        self.ln1.zero_()
        self.ln2.zero_()
        self.init_attn(self.attn, self.cfg, gen)
        if self.cfg.n_experts:
            self.moe.init(gen)
        else:
            init_mlp(self.mlp, gen)

    def ffn(self, x: torch.Tensor, moe_impl: str = "scatter", mesh=None,
            data_axes: Tuple[str, ...] = ("data",)
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The pre-normed MLP (or MoE) branch and its aux loss (None for an
        MLP); ``moe_impl``, ``mesh`` and ``data_axes`` go to
        ``moe_apply``."""
        cfg = self.cfg
        hn = rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.n_experts:
            return moe_mod.moe_apply(self.moe, hn, cfg, moe_impl, mesh,
                                     data_axes)
        return mlp_apply(self.mlp, hn, cfg.act), None


class LMBase(nn.Module):
    """What every family's LM shares: ``embed (vocab, d)`` and
    ``final_norm (d,)`` in the model dtype on the model's device (``cuda``
    unless told), the scaled embedding lookup and the tied head."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.embed = _param(torch.empty((cfg.vocab, cfg.d_model),
                                        dtype=self.dtype, device=dev))
        self.final_norm = _param(torch.zeros(cfg.d_model, dtype=self.dtype,
                                             device=dev))

    @property
    def device(self) -> torch.device:
        """Where the weights are: a model built on ``meta`` and loaded
        with ``load_state_dict(..., assign=True)`` runs where they were."""
        return self.embed.device

    def init_embed(self, gen: torch.Generator) -> None:
        embed_init(gen, self.cfg.vocab, self.cfg.d_model, self.dtype,
                   out=self.embed)
        self.final_norm.zero_()

    def embed_inputs(self, tok) -> torch.Tensor:
        """Token ids (any int array) -> embeddings times d_model**0.5, the
        scale cast to the model dtype as the reference does."""
        x = self.embed[torch.as_tensor(tok, device=self.device).long()]
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype,
                                device=self.device)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return rms_norm(h, self.final_norm, self.cfg.norm_eps) @ self.embed.T

    def tokens(self, batch: Dict) -> torch.Tensor:
        """The batch's token ids on the model's device."""
        return torch.as_tensor(batch["tokens"], device=self.device)


#: where a layer's cache lives: the path of its dict in the caches and its
#: index along that dict's leading (stacked) axes
Where = Tuple[Tuple[str, ...], Tuple[int, ...]]


def _node(tree: Dict, path: Tuple[str, ...]) -> Dict:
    for key in path:
        tree = tree.setdefault(key, {})
    return tree


class TransformerLM(LMBase):
    """cfg.family in {dense, moe, vlm}."""

    def __init__(self, cfg: ModelConfig, device=None,
                 moe_impl: str = "scatter", mesh=None,
                 data_axes: Tuple[str, ...] = ("data",)):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"TransformerLM serves the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        moe_mod.check_impl(moe_impl, mesh)
        super().__init__(cfg, device)
        self.moe_impl, self.mesh, self.data_axes = moe_impl, mesh, data_axes
        dev, dt = self.device, self.dtype
        experts = moe_mod.expert_range(cfg, mesh) \
            if cfg.n_experts and moe_impl == "a2a" else None

        def block():
            return DenseBlock(cfg, dt, dev, experts)
        period = cfg.local_global_period
        # layers: (block, is_global, where its cache lives); stacks: each
        # cache dict's path -> (leading axes, is_global)
        self._layers: List[Tuple[DenseBlock, bool, Where]] = []
        self._stacks: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], bool]] \
            = {}
        if period:
            n_groups, n_tail = divmod(cfg.n_layers, period)
            self.blocks = nn.ModuleList(
                nn.ModuleList(block() for _ in range(period))
                for _ in range(n_groups))
            self.tail = nn.ModuleList(block() for _ in range(n_tail))
            for g, group in enumerate(self.blocks):
                for l, blk in enumerate(group):
                    is_global = (l + 1) % period == 0
                    where = (("groups", "global"), (g,)) if is_global \
                        else (("groups", "local"), (g, l))
                    self._layers.append((blk, is_global, where))
            self._layers += [(blk, False, (("tail",), (t,)))
                             for t, blk in enumerate(self.tail)]
            self._stacks[("groups", "local")] = ((n_groups, period - 1),
                                                 False)
            self._stacks[("groups", "global")] = ((n_groups,), True)
            if n_tail:
                self._stacks[("tail",)] = ((n_tail,), False)
        else:
            self.blocks = nn.ModuleList(block() for _ in range(cfg.n_layers))
            is_global = cfg.window == 0
            self._layers = [(blk, is_global, ((), (i,)))
                            for i, blk in enumerate(self.blocks)]
            self._stacks[()] = ((cfg.n_layers,), is_global)
        if not cfg.tie_embeddings:
            self.unembed = _param(torch.empty((cfg.d_model, cfg.vocab),
                                              dtype=dt, device=dev))
        if cfg.family == "vlm":
            self.vision_proj = _param(torch.empty(
                (cfg.d_model, cfg.d_model), dtype=dt, device=dev))

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "TransformerLM":
        """He-normal weights and embeddings from ``gen`` (on the model's
        device), zero norm scales."""
        cfg = self.cfg
        self.init_embed(gen)
        for blk, _, _ in self._layers:
            blk.init(gen)
        if not cfg.tie_embeddings:
            self.unembed.copy_(embed_init(gen, cfg.vocab, cfg.d_model,
                                          self.dtype).T)
        if cfg.family == "vlm":
            self.vision_proj.copy_(embed_init(gen, cfg.d_model, cfg.d_model,
                                              self.dtype).T)
        return self

    def head(self) -> torch.Tensor:
        """The (d, vocab) unembedding: ``embed.T`` when tied."""
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return rms_norm(h, self.final_norm, self.cfg.norm_eps) @ self.head()

    def embed_batch(self, batch: Dict) -> torch.Tensor:
        """The scaled token embeddings, prefixed for the VLM by the batch's
        ``vision`` embeddings (B, Nv, d) cast to the model dtype and
        projected by ``vision_proj``."""
        x = self.embed_inputs(batch["tokens"])
        if self.cfg.family == "vlm" and "vision" in batch:
            vis = torch.as_tensor(batch["vision"], device=self.device)
            x = torch.cat([vis.to(self.dtype) @ self.vision_proj, x], dim=1)
        return x

    # ----------------------------------------------------------- seq path
    def _block_seq(self, blk: DenseBlock, x: torch.Tensor,
                   positions: torch.Tensor, is_global: bool,
                   with_cache: bool, train: bool):
        """One layer over the sequence: (x, cache or None, aux or None)."""
        cfg = self.cfg
        h, c = attn.attn_prefill(
            blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), positions, cfg,
            is_global, with_cache, train=train)
        x = x + h
        y, a = blk.ffn(x, self.moe_impl, self.mesh, self.data_axes)
        return x + y, c, a

    def forward(self, batch: Dict, with_cache: bool = False,
                train: bool = False
                ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
        """Returns (hidden (B,S,D), caches or None, the MoE aux loss summed
        over layers, 0 without experts). ``train`` takes the differentiable
        route, each layer recomputed in the backward pass when
        ``cfg.remat``."""
        cfg = self.cfg
        x = self.embed_batch(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        caches: Optional[Dict] = {} if with_cache else None
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        block = remat(self._block_seq, train and cfg.remat)
        for blk, is_global, (path, idx) in self._layers:
            x, c, a = block(blk, x, positions, is_global, with_cache, train)
            if a is not None:
                aux = aux + a
            if with_cache:
                node = _node(caches, path)
                lead = self._stacks[path][0]
                for n, t in c.items():
                    if n not in node:
                        node[n] = t.new_empty((*lead, *t.shape))
                    node[n][idx] = t
        return x, caches, aux

    # --------------------------------------------------------------- loss
    def loss_fn(self, batch: Dict
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over ``batch["tokens"]`` (B, S+1) (the
        VLM's on its text positions only), through the differentiable
        route; ``cfg.ce_chunk > 1`` chunks it; MoE adds ``0.01 · aux``.
        Returns (loss, {"ce": loss, "aux": aux}), as the reference."""
        cfg = self.cfg
        tokens = self.tokens(batch)
        h, _, aux = self.forward({**batch, "tokens": tokens[:, :-1]},
                                 train=True)
        labels = tokens[:, 1:]
        if cfg.family == "vlm" and "vision" in batch:
            h = h[:, batch["vision"].shape[1]:]
        if cfg.ce_chunk > 1:
            loss = chunked_ce(rms_norm(h, self.final_norm, cfg.norm_eps),
                              self.head(), labels, cfg.ce_chunk)
        else:
            loss = cross_entropy(self.logits(h), labels)
        if cfg.n_experts:
            loss = loss + 0.01 * aux
        return loss, {"ce": loss, "aux": aux}

    # ------------------------------------------------------------ serving
    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """Last-token logits (B,1,V) and the caches, grown to
        ``cache_len`` when given."""
        h, caches, _ = self.forward(batch, with_cache=True)
        logits = self.logits(h[:, -1:])
        if cache_len is not None:
            for path, (_, is_global) in self._stacks.items():
                node = _node(caches, path)
                node.update(attn.grow_cache(node, self.cfg, is_global,
                                            cache_len, h.shape[1]))
        return logits, caches

    def decode_step(self, caches: Caches, batch: Dict
                    ) -> Tuple[torch.Tensor, Caches]:
        """batch: {"token": (B,1) ints, "pos": int}. Returns (logits
        (B,1,V), caches), the caches updated in place."""
        cfg = self.cfg
        pos = int(batch["pos"])
        x = self.embed_inputs(batch["token"])
        for blk, is_global, (path, idx) in self._layers:
            layer = {n: t[idx] for n, t in _node(caches, path).items()}
            h, _ = attn.attn_decode(
                blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), layer, pos,
                cfg, is_global)
            x = x + h
            x = x + blk.ffn(x, self.moe_impl, self.mesh,
                            self.data_axes)[0]
        return self.logits(x), caches

    # ------------------------------------------------------------- caches
    def init_caches(self, batch: int, cache_len: int) -> Caches:
        caches: Dict = {}
        for path, (lead, is_global) in self._stacks.items():
            one = attn.init_cache(self.cfg, batch, cache_len, is_global,
                                  self.dtype, self.device)
            _node(caches, path).update(
                {n: t.expand(*lead, *t.shape).clone() for n, t in one.items()})
        return caches
