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

On a device mesh (``mesh=``; ROADMAP queue A item 13b) each rank holds its
slices of ``param_pspecs()``, the reference's layout: the embedding
vocab-parallel when the vocabulary divides the model axis (each rank looks
up the ids in its range, zeroes the rest, and the ranks sum: one non-zero
term an entry, exact), attention on the rank's heads
(``attention.attn_layout``), the MLP column- then row-parallel (or the
swap), MoE banks expert-parallel or split per expert (``moe``), and the
head's vocab-sharded logits gathered over the model axis, so every rank
returns the whole logits and picks the unsharded model's greedy tokens.
``prefill`` and ``decode_step`` take the whole batch and run this data
shard's rows of it (``batch_pspecs``: batch on the data axes), keep their
caches (``cache_pspecs``; the rank's kv heads, see
``attention``) and return every row's logits, gathered over the data
axes; a batch of 1 over several data shards runs replicated and keeps
each shard's slots of every cache (sequence-parallel decode,
``attention.attn_decode(seq=True)``). ``loss_fn`` runs the whole batch
on every rank (PR 22's ``a2a`` training), or with ``local_rows`` this
data shard's rows, the loss the whole batch's (the mesh train step of
``launch.steps``). ``mesh_tp`` and the ``*_pspecs`` methods are the
reference's, their keys the state dict's names (a cache spec's leading
axes are its stacked layers', as the reference's).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import attention as attn
from . import moe as moe_mod
from .layers import (DTYPES, NO_MESH, P, Sharding, chunked_ce, cross_entropy,
                     divisible, draw_into, embed_pspec, init_mlp, merge_index,
                     mlp_apply, mlp_params, mlp_pspec, remat, rms_norm)

__all__ = ["TransformerLM", "LMBase", "DenseBlock", "mesh_tp",
           "with_leading", "flat_specs"]

Caches = Dict[str, object]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def mesh_tp(mesh) -> Optional[int]:
    """Model-axis size of a mesh (None when no mesh / no model axis)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    return int(mesh.shape[mesh.mesh_dim_names.index("model")])


def with_leading(tree, n_axes: int = 1):
    """Every spec of ``tree`` with ``n_axes`` unsharded leading axes (the
    reference's ``_with_leading``, for layer-stacked caches)."""
    if isinstance(tree, P):
        return P(*([None] * n_axes), *tree)
    if isinstance(tree, dict):
        return {k: with_leading(v, n_axes) for k, v in tree.items()}
    return type(tree)(with_leading(v, n_axes) for v in tree)


def flat_specs(tree: Dict, prefix: str = "") -> Dict[str, P]:
    """A nested spec dict as ``{"a.b.c": P}``."""
    out: Dict[str, P] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, P):
            out[name] = v
        else:
            out.update(flat_specs(v, name + "."))
    return out


def embed_lookup(embed: torch.Tensor, tok, sh: Sharding, vocab: int
                 ) -> torch.Tensor:
    """``embed`` rows of token ids (any int array); vocab-parallel when
    ``embed`` holds the rank's rows of the ``vocab``: ids outside its
    range give zeros, and the ranks' rows are summed (one non-zero term an
    entry: exact)."""
    ids = torch.as_tensor(tok, device=embed.device).long()
    n = embed.shape[0]
    if n == vocab:
        return embed[ids]
    lo = sh.rank * n
    mine = (ids >= lo) & (ids < lo + n)
    x = embed[torch.where(mine, ids - lo, 0)]
    return sh.reduce(torch.where(mine[..., None], x, 0))


def head_logits(hn: torch.Tensor, head: torch.Tensor, sh: Sharding,
                vocab: int) -> torch.Tensor:
    """Normed hidden states through the ``(d, vocab)`` head: the whole
    vocabulary on every rank (a head of the rank's vocab columns has its
    logits gathered over the model axis)."""
    if head.shape[1] == vocab:
        return hn @ head
    return sh.gather(sh.enter(hn) @ head, -1)


def block_pspec(cfg: ModelConfig, tp: Optional[int] = None) -> Dict:
    """The reference's ``_block_pspec``: one layer's specs."""
    p = {"ln1": P(None), "ln2": P(None), "attn": attn.attn_pspec(cfg, tp)}
    if cfg.n_experts:
        p["moe"] = moe_mod.moe_pspec(cfg, tp)
    else:
        p["mlp"] = mlp_pspec(cfg.act, cfg.d_ff, tp)
    return p


def _module_specs(model: nn.Module, kind, spec: Dict) -> Dict[str, P]:
    """``spec`` (one block's) under the name of every ``kind`` module."""
    out: Dict[str, P] = {}
    for name, m in model.named_modules():
        if type(m) is kind:
            out.update(flat_specs(spec, name + "."))
    return out


class DenseBlock(nn.Module):
    """One pre-norm attention + MLP (or MoE) layer; parameters allocated,
    not initialised (``init`` fills them)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device, sh: Sharding = NO_MESH):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim

        def zeros(n):
            return _param(torch.zeros(n, dtype=dtype, device=device))

        self.ln1, self.ln2 = zeros(d), zeros(d)
        self.attn = self.attn_params(cfg, dtype, device, sh)
        if cfg.n_experts:
            self.moe = moe_mod.MoE(cfg, dtype, device, sh=sh)
        else:
            self.mlp = mlp_params(d, cfg.d_ff, cfg.act, dtype, device, sh)
        self.cfg, self.sh = cfg, sh

    @staticmethod
    def attn_params(cfg: ModelConfig, dtype: torch.dtype,
                    device: torch.device, sh: Sharding = NO_MESH
                    ) -> nn.ParameterDict:
        """An attention layer's ``{wq, wk, wv, wo[, q_norm, k_norm]}``:
        on a mesh the rank's slices of ``attn_pspec``'s layout."""
        spec = attn.attn_pspec(cfg, sh.spec_tp)
        return nn.ParameterDict({
            n: _param(torch.zeros(shape, dtype=dtype, device=device)
                      if n.endswith("norm") else
                      torch.empty(sh.local_shape(spec[n], shape),
                                  dtype=dtype, device=device))
            for n, shape in attn.attn_full_shapes(cfg).items()})

    @staticmethod
    @torch.no_grad()
    def init_attn(a: nn.ParameterDict, cfg: ModelConfig,
                  gen: torch.Generator, sh: Sharding = NO_MESH) -> None:
        """He-normal projections from ``gen`` (a rank keeps its slices of
        the whole draws), zero qk-norm scales."""
        spec, full = attn.attn_pspec(cfg, sh.spec_tp), \
            attn.attn_full_shapes(cfg)
        for n, groups in (("wq", (1, 2)), ("wk", (1, 2)), ("wv", (1, 2)),
                          ("wo", (2, 1))):
            shape = full[n]
            draw = (shape[0], shape[1] * shape[2]) if groups == (1, 2) \
                else (shape[0] * shape[1], shape[2])
            draw_into(gen, a[n], draw, draw[0], merge_index(
                sh.index(spec[n], shape), shape, groups))
        if cfg.qk_norm:
            a["q_norm"].zero_()
            a["k_norm"].zero_()

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        """He-normal projections from ``gen``, zero norm scales."""
        cfg = self.cfg
        self.ln1.zero_()
        self.ln2.zero_()
        self.init_attn(self.attn, cfg, gen, self.sh)
        if cfg.n_experts:
            self.moe.init(gen)
        else:
            init_mlp(self.mlp, gen, cfg.d_model, cfg.d_ff, cfg.act, self.sh)

    def ffn(self, x: torch.Tensor, moe_impl: str = "scatter", mesh=None,
            data_axes: Tuple[str, ...] = ("data",), local_rows: bool = False,
            train: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The pre-normed MLP (or MoE) branch and its aux loss (None for an
        MLP); ``moe_impl``, ``mesh``, ``data_axes``, ``local_rows`` and
        ``train`` go to ``moe_apply``."""
        cfg = self.cfg
        hn = rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.n_experts:
            return moe_mod.moe_apply(self.moe, hn, cfg, moe_impl, mesh,
                                     data_axes, sh=self.sh,
                                     local_rows=local_rows, train=train)
        return mlp_apply(self.mlp, hn, cfg.act, self.sh, cfg.d_ff), None


class LMBase(nn.Module):
    """What every family's LM shares: ``embed (vocab, d)`` and
    ``final_norm (d,)`` in the model dtype on the model's device (``cuda``
    unless told), the scaled embedding lookup and the tied head."""

    def __init__(self, cfg: ModelConfig, device=None, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",)):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.mesh, self.data_axes = mesh, tuple(data_axes)
        self.sh = Sharding(mesh, data_axes) if mesh is not None else NO_MESH
        self.embed = _param(torch.empty(
            self.sh.local_shape(self._embed_spec(), (cfg.vocab, cfg.d_model)),
            dtype=self.dtype, device=dev))
        self.final_norm = _param(torch.zeros(cfg.d_model, dtype=self.dtype,
                                             device=dev))

    @property
    def device(self) -> torch.device:
        """Where the weights are: a model built on ``meta`` and loaded
        with ``load_state_dict(..., assign=True)`` runs where they were."""
        return self.embed.device

    def _embed_spec(self) -> P:
        return embed_pspec(self.cfg.vocab, self.sh.spec_tp)

    def init_embed(self, gen: torch.Generator) -> None:
        shape = (self.cfg.vocab, self.cfg.d_model)
        draw_into(gen, self.embed, shape, shape[1],
                  self.sh.index(self._embed_spec(), shape))
        self.final_norm.zero_()

    def embed_inputs(self, tok) -> torch.Tensor:
        """Token ids (any int array) -> embeddings times d_model**0.5, the
        scale cast to the model dtype as the reference does."""
        scale = torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype,
                             device=self.device)
        return embed_lookup(self.embed, tok, self.sh, self.cfg.vocab) * scale

    def head(self) -> torch.Tensor:
        """The (d, vocab) unembedding (on a mesh the rank's columns)."""
        return self.embed.T

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of the final hidden states, the whole vocabulary on every
        rank (a vocab-sharded head's gathered over the model axis)."""
        return head_logits(rms_norm(h, self.final_norm, self.cfg.norm_eps),
                           self.head(), self.sh, self.cfg.vocab)

    def split_batch(self, batch: Dict) -> Dict:
        """This data shard's rows of every batched input (``batch_pspecs``:
        batch on the data axes; a batch of 1 is replicated, and served
        sequence-parallel)."""
        return {k: self.sh.split_rows(v) for k, v in batch.items()}

    def rows(self, batch: Dict) -> int:
        """The batch's rows (of its first batched input)."""
        return next(int(v.shape[0]) for v in batch.values()
                    if getattr(v, "ndim", 0))

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
        super().__init__(cfg, device, mesh, data_axes)
        self.moe_impl = moe_impl
        dev, dt, sh = self.device, self.dtype, self.sh

        def block():
            return DenseBlock(cfg, dt, dev, sh)
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
        specs = self.param_pspecs()
        if not cfg.tie_embeddings:
            self.unembed = _param(torch.empty(sh.local_shape(
                specs["unembed"], (cfg.d_model, cfg.vocab)), dtype=dt,
                device=dev))
        if cfg.family == "vlm":
            self.vision_proj = _param(torch.empty(sh.local_shape(
                specs["vision_proj"], (cfg.d_model, cfg.d_model)), dtype=dt,
                device=dev))

    # ------------------------------------------------------------- specs
    def param_pspecs(self) -> Dict[str, P]:
        """The reference's parameter specs under the state dict's names
        (a block's without the reference's leading layer axes)."""
        cfg, tp = self.cfg, self.sh.spec_tp
        emb = embed_pspec(cfg.vocab, tp)
        specs = {"embed": emb, "final_norm": P(None),
                 **_module_specs(self, DenseBlock, block_pspec(cfg, tp))}
        if not cfg.tie_embeddings:
            specs["unembed"] = P(*reversed(tuple(emb)))
        if cfg.family == "vlm":
            dm = "model" if divisible(cfg.d_model, tp) else None
            specs["vision_proj"] = P(None, dm)
        return specs

    def cache_pspecs(self, shard_seq: bool) -> Dict:
        """The reference's cache specs, nested and stacked as the caches."""
        cfg = self.cfg
        batch_axes = self.data_axes if len(self.data_axes) > 1 \
            else self.data_axes[0]
        kv_ok = divisible(cfg.n_kv_heads, self.sh.spec_tp)
        base = attn.cache_pspec(batch_axes, shard_seq, kv_ok,
                                quantized=cfg.kv_dtype == "int8")
        if cfg.local_global_period:
            caches = {"groups": {"local": with_leading(base, 2),
                                 "global": with_leading(base, 1)}}
            if ("tail",) in self._stacks:
                caches["tail"] = with_leading(base, 1)
            return caches
        return with_leading(base, 1)

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "TransformerLM":
        """He-normal weights and embeddings from ``gen`` (on the model's
        device), zero norm scales; on a mesh each rank keeps its slices of
        the unsharded draws."""
        cfg, sh = self.cfg, self.sh
        self.init_embed(gen)
        for blk, _, _ in self._layers:
            blk.init(gen)
        specs = self.param_pspecs()
        for name, n in (("unembed", cfg.vocab), ("vision_proj", cfg.d_model)):
            if hasattr(self, name):     # the transpose of an embed draw
                draw = (n, cfg.d_model)
                idx = sh.index(specs[name], (cfg.d_model, n))
                draw_into(gen, getattr(self, name), draw, cfg.d_model,
                          (idx[1], idx[0]), transpose=True)
        return self

    def head(self) -> torch.Tensor:
        """The (d, vocab) unembedding: ``embed.T`` when tied (on a mesh the
        rank's columns)."""
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def embed_batch(self, batch: Dict) -> torch.Tensor:
        """The scaled token embeddings, prefixed for the VLM by the batch's
        ``vision`` embeddings (B, Nv, d) cast to the model dtype and
        projected by ``vision_proj``."""
        x = self.embed_inputs(batch["tokens"])
        if self.cfg.family == "vlm" and "vision" in batch:
            vis = torch.as_tensor(batch["vision"], device=self.device)
            vis = vis.to(self.dtype)
            if self.vision_proj.shape[1] < self.cfg.d_model:
                proj = self.sh.gather(self.sh.enter(vis) @ self.vision_proj,
                                      -1)
            else:
                proj = vis @ self.vision_proj
            x = torch.cat([proj, x], dim=1)
        return x

    # ----------------------------------------------------------- seq path
    def _block_seq(self, blk: DenseBlock, x: torch.Tensor,
                   positions: torch.Tensor, is_global: bool,
                   with_cache: bool, train: bool, local_rows: bool = False):
        """One layer over the sequence: (x, cache or None, aux or None)."""
        cfg = self.cfg
        h, c = attn.attn_prefill(
            blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), positions, cfg,
            is_global, with_cache, train=train, sh=self.sh)
        x = x + h
        y, a = blk.ffn(x, self.moe_impl, self.mesh, self.data_axes,
                       local_rows, train)
        return x + y, c, a

    def forward(self, batch: Dict, with_cache: bool = False,
                train: bool = False, local_rows: bool = False,
                cache_len: Optional[int] = None, seq: bool = False
                ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
        """Returns (hidden (B,S,D), caches or None, the MoE aux loss summed
        over layers, 0 without experts). ``train`` takes the differentiable
        route, each layer recomputed in the backward pass when
        ``cfg.remat``. ``local_rows``: ``batch`` is this data shard's rows
        (``prefill``'s and the mesh train step's), not the whole batch.
        ``cache_len``: each layer's cache grown to it as it is made
        (``attention.grow_cache``), and with ``seq`` only the data shard's
        slots of it kept."""
        cfg = self.cfg
        x = self.embed_batch(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        caches: Optional[Dict] = {} if with_cache else None
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        block = remat(self._block_seq, train and cfg.remat)
        for blk, is_global, (path, idx) in self._layers:
            x, c, a = block(blk, x, positions, is_global, with_cache, train,
                            local_rows)
            if a is not None:
                aux = aux + a
            if with_cache:
                if cache_len is not None or seq:
                    c = attn.grow_cache(c, cfg, is_global, cache_len or s,
                                        s, self.sh, seq)
                node = _node(caches, path)
                lead = self._stacks[path][0]
                for n, t in c.items():
                    if n not in node:
                        node[n] = t.new_empty((*lead, *t.shape))
                    node[n][idx] = t
        return x, caches, aux

    # --------------------------------------------------------------- loss
    def loss_fn(self, batch: Dict, local_rows: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over ``batch["tokens"]`` (B, S+1) (the
        VLM's on its text positions only), through the differentiable
        route; ``cfg.ce_chunk > 1`` chunks it; MoE adds ``0.01 · aux``.
        Returns (loss, {"ce": loss, "aux": aux}), as the reference.
        ``local_rows``: ``batch`` is this data shard's rows; the loss is
        the whole batch's (the shards' mean, the MoE's aux and capacity
        the whole batch's) and each shard's gradients are its rows' part,
        which the train step sums over the data shards."""
        cfg = self.cfg
        tokens = self.tokens(batch)
        h, _, aux = self.forward({**batch, "tokens": tokens[:, :-1]},
                                 train=True, local_rows=local_rows)
        labels = tokens[:, 1:]
        if cfg.family == "vlm" and "vision" in batch:
            h = h[:, batch["vision"].shape[1]:]
        if cfg.ce_chunk > 1:
            loss = chunked_ce(rms_norm(h, self.final_norm, cfg.norm_eps),
                              self.head(), labels, cfg.ce_chunk)
        else:
            loss = cross_entropy(self.logits(h), labels)
        if local_rows:
            loss = self.sh.mean_data(loss)
        if cfg.n_experts:
            loss = loss + 0.01 * aux
        return loss, {"ce": loss, "aux": aux}

    # ------------------------------------------------------------ serving
    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """Last-token logits (B,1,V) and the caches, grown to
        ``cache_len`` when given (on a mesh: this data shard's rows of the
        caches, every row's logits; a batch of 1 over several data shards
        runs replicated and keeps the shard's slots of each cache)."""
        rows = self.rows(batch)
        seq = self.sh.seq_parallel(rows)
        h, caches, _ = self.forward(self.split_batch(batch), with_cache=True,
                                    local_rows=not seq, cache_len=cache_len,
                                    seq=seq)
        return self.sh.gather_rows(self.logits(h[:, -1:]), rows), caches

    def decode_step(self, caches: Caches, batch: Dict
                    ) -> Tuple[torch.Tensor, Caches]:
        """batch: {"token": (B,1) ints, "pos": int}. Returns (logits
        (B,1,V), caches), the caches updated in place."""
        cfg = self.cfg
        pos = int(batch["pos"])
        rows = int(batch["token"].shape[0])
        seq = self.sh.seq_parallel(rows)
        x = self.embed_inputs(self.sh.split_rows(batch["token"]))
        for blk, is_global, (path, idx) in self._layers:
            layer = {n: t[idx] for n, t in _node(caches, path).items()}
            h, _ = attn.attn_decode(
                blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), layer, pos,
                cfg, is_global, self.sh, seq=seq)
            x = x + h
            x = x + blk.ffn(x, self.moe_impl, self.mesh,
                            self.data_axes, local_rows=not seq)[0]
        return self.sh.gather_rows(self.logits(x), rows), caches

    # ------------------------------------------------------------- caches
    def init_caches(self, batch: int, cache_len: int) -> Caches:
        """Zero caches for a batch of ``batch`` (on a mesh this data
        shard's rows and the rank's kv heads)."""
        caches: Dict = {}
        rows = self.sh.local_rows(batch)
        for path, (lead, is_global) in self._stacks.items():
            one = attn.init_cache(self.cfg, rows, cache_len, is_global,
                                  self.dtype, self.device, self.sh,
                                  seq=self.sh.seq_parallel(batch))
            _node(caches, path).update(
                {n: t.expand(*lead, *t.shape).clone() for n, t in one.items()})
        return caches
