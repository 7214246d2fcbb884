"""Whisper-medium's backbone: a transformer encoder over (stubbed) audio
frame embeddings and a causal decoder with cross attention — the port of
``repro/models/encdec.py`` for serving.

The conv frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``audio_embeds (B, S_enc, D)``. The encoder
adds sinusoidal positions and runs bidirectional self-attention through
B3 (``causal=False``), with the RoPE that every self-attention applies on
top of them (a quirk of the reference, kept). The decoder adds learned
positions ``dec_pos (8192, d)`` to its unscaled token embeddings, attends
causally to itself (B3 in the prefill, B4 over its self cache in decode)
and, without mask or RoPE, to the encoder's frames (plain PyTorch, as in
the reference: ``attention.cross_attn_apply``). Its head is ``embed.T``.

Parameters, in the reference's names (``models.convert`` maps its
pytree): ``enc_blocks.<i>.{ln1, attn.*, ln2, mlp.*}``, ``enc_norm``,
``dec_blocks.<i>.{ln1, attn.*, ln_x, xattn.*, ln2, mlp.*}``, ``dec_norm``,
``embed (vocab, d)`` and ``dec_pos``. ``loss_fn`` runs the encoder and the
decoder on the differentiable route (``train=True``: the chunked
attention, bidirectional in the encoder, in place of B3), each layer a
``torch.utils.checkpoint`` region when ``cfg.remat``. Caches are ``{"self": {"k", "v"}
(L, B, C, K, hd), "cross": {"k", "v"} (L, B, S_enc, K, hd)}``; the cross
keys and values are computed once, in the prefill.

On a device mesh (``mesh=``) each rank holds its slices of
``param_pspecs()`` (the reference's: every self and cross attention on
the rank's heads, the MLPs column- then row-parallel, the embedding
vocab-parallel when the vocabulary divides the model axis; whisper's
51,865 does not, and stays whole), its caches the rank's kv heads (the
cross caches too), and ``prefill`` / ``decode_step`` split a served
batch's rows over the data axes as ``TransformerLM`` does; a batch of 1
over several data shards runs replicated, each shard keeping its slots
of the self caches and the cross caches whole (sequence-parallel
decode).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import attention as attn
from .layers import (DTYPES, NO_MESH, P, Sharding, cross_entropy, divisible,
                     draw_into, embed_pspec, mlp_pspec, remat, rms_norm)
from .transformer import (DenseBlock, _module_specs, _param, embed_lookup,
                          head_logits, with_leading)

__all__ = ["EncDecLM", "CROSS_FRAMES"]

CROSS_FRAMES = 1500     # whisper: 30 s of audio -> 1500 encoder frames
#: learned decoder positions
DEC_POSITIONS = 8192

Caches = Dict[str, Dict[str, torch.Tensor]]


def _sinusoid(s: int, d: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


class DecBlock(DenseBlock):
    """A decoder layer: the encoder's layer plus ``ln_x`` and the cross
    attention's ``xattn.{wq, wk, wv, wo}``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device, sh: Sharding = NO_MESH):
        super().__init__(cfg, dtype, device, sh)
        self.ln_x = _param(torch.zeros(cfg.d_model, dtype=dtype,
                                       device=device))
        self.xattn = self.attn_params(cfg, dtype, device, sh)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        super().init(gen)
        self.ln_x.zero_()
        self.init_attn(self.xattn, self.cfg, gen, self.sh)


class EncDecLM(nn.Module):
    """cfg.family == "encdec"."""

    def __init__(self, cfg: ModelConfig, device=None, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",)):
        super().__init__()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.dtype = dt = DTYPES[cfg.dtype]
        self.mesh, self.data_axes = mesh, tuple(data_axes)
        self.sh = sh = Sharding(mesh, data_axes) if mesh is not None \
            else NO_MESH
        d = cfg.d_model
        self.enc_blocks = nn.ModuleList(DenseBlock(cfg, dt, dev, sh)
                                        for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, dt, dev, sh)
                                        for _ in range(cfg.dec_layers))
        self.enc_norm = _param(torch.zeros(d, dtype=dt, device=dev))
        self.dec_norm = _param(torch.zeros(d, dtype=dt, device=dev))
        self.embed = _param(torch.empty(sh.local_shape(
            embed_pspec(cfg.vocab, sh.spec_tp), (cfg.vocab, d)), dtype=dt,
            device=dev))
        self.dec_pos = _param(torch.empty((DEC_POSITIONS, d), dtype=dt,
                                          device=dev))

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's specs under the state dict's names."""
        cfg, tp = self.cfg, self.sh.spec_tp
        enc = {"ln1": P(None), "attn": attn.attn_pspec(cfg, tp),
               "ln2": P(None), "mlp": mlp_pspec(cfg.act, cfg.d_ff, tp)}
        dec = {**enc, "ln_x": P(None), "xattn": attn.attn_pspec(cfg, tp)}
        return {**_module_specs(self, DenseBlock, enc),
                **_module_specs(self, DecBlock, dec),
                "enc_norm": P(None), "dec_norm": P(None),
                "embed": embed_pspec(cfg.vocab, tp),
                "dec_pos": P(None, None)}

    def cache_pspecs(self, shard_seq: bool) -> Dict:
        """The reference's cache specs, stacked as the caches."""
        batch_axes = self.data_axes if len(self.data_axes) > 1 \
            else self.data_axes[0]
        kv_ok = divisible(self.cfg.n_kv_heads, self.sh.spec_tp)
        base = attn.cache_pspec(batch_axes, shard_seq, kv_ok,
                                quantized=self.cfg.kv_dtype == "int8")
        cross = attn.cache_pspec(batch_axes, False, kv_ok)
        return {"self": with_leading(base, 1),
                "cross": with_leading(cross, 1)}

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "EncDecLM":
        """He-normal weights and embeddings from ``gen`` (on the model's
        device), zero norm scales; on a mesh each rank keeps its slices of
        the unsharded draws."""
        for blk in (*self.enc_blocks, *self.dec_blocks):
            blk.init(gen)
        self.enc_norm.zero_()
        self.dec_norm.zero_()
        d, v = self.cfg.d_model, self.cfg.vocab
        draw_into(gen, self.embed, (v, d), d, self.sh.index(
            embed_pspec(v, self.sh.spec_tp), (v, d)))
        draw_into(gen, self.dec_pos, (DEC_POSITIONS, d), d)
        return self

    # ------------------------------------------------------------ encoder
    def _enc_block(self, blk: DenseBlock, x: torch.Tensor,
                   positions: torch.Tensor, train: bool) -> torch.Tensor:
        h, _ = attn.attn_prefill(
            blk.attn, rms_norm(x, blk.ln1, self.cfg.norm_eps), positions,
            self.cfg, True, False, causal=False, train=train,
            sh=self.sh)                                     # bidirectional
        x = x + h
        return x + blk.ffn(x)[0]

    def encode(self, audio_embeds, train: bool = False) -> torch.Tensor:
        """(B, S_enc, d) frame embeddings (any float array) -> the normed
        encoder output."""
        cfg = self.cfg
        x = torch.as_tensor(audio_embeds, device=self.device).to(self.dtype)
        b, s, d = x.shape
        x = x + _sinusoid(s, d, self.dtype, self.device)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        block = remat(self._enc_block, train and cfg.remat)
        for blk in self.enc_blocks:
            x = block(blk, x, positions, train)
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    def cross_caches(self, enc_out: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every decoder layer's cross keys and values of ``enc_out``,
        stacked: {"k", "v"} (L, B, S_enc, K, hd)."""
        kv = [attn.cross_kv(blk.xattn, enc_out, self.cfg, self.sh)
              for blk in self.dec_blocks]
        return {"k": torch.stack([k for k, _ in kv]),
                "v": torch.stack([v for _, v in kv])}

    # ------------------------------------------------------------ decoder
    def _dec_block(self, blk: DecBlock, x: torch.Tensor, enc_k, enc_v,
                   attend) -> torch.Tensor:
        """One decoder layer around its self-attention ``attend(p, xn)``."""
        cfg = self.cfg
        x = x + attend(blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps))
        x = x + attn.cross_attn_apply(
            blk.xattn, rms_norm(x, blk.ln_x, cfg.norm_eps), enc_k, enc_v,
            cfg, self.sh)
        return x + blk.ffn(x)[0]

    def decode_seq(self, tokens, cross: Dict[str, torch.Tensor],
                   with_cache: bool = False, train: bool = False,
                   cache_len: Optional[int] = None, seq: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """The decoder over a token sequence against the stacked cross keys
        and values ``cross``: (normed hidden (B,S,D), self caches (L, B, S,
        K, hd) or None; ``cache_len`` and ``seq`` as
        ``TransformerLM.forward``'s)."""
        cfg = self.cfg
        tok = torch.as_tensor(tokens, device=self.device).long()
        b, s = tok.shape
        x = embed_lookup(self.embed, tok, self.sh, cfg.vocab) \
            + self.dec_pos[:s]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        caches: Optional[Dict] = {} if with_cache else None
        block = remat(self._dec_block, train and cfg.remat)
        for i, blk in enumerate(self.dec_blocks):
            def attend(p, xn):
                h, c = attn.attn_prefill(p, xn, positions, cfg, True,
                                         with_cache, train=train, sh=self.sh)
                if with_cache:
                    if cache_len is not None or seq:
                        c = attn.grow_cache(c, cfg, True, cache_len or s, s,
                                            self.sh, seq)
                    for n, t in c.items():
                        if n not in caches:
                            caches[n] = t.new_empty((cfg.dec_layers,
                                                     *t.shape))
                        caches[n][i] = t
                return h
            x = block(blk, x, cross["k"][i], cross["v"][i], attend)
        return rms_norm(x, self.dec_norm, cfg.norm_eps), caches

    # --------------------------------------------------------------- loss
    def loss_fn(self, batch: Dict, local_rows: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"audio_embeds" (B, S_enc, d), "tokens" (B, S+1)}: the
        decoder's next-token cross entropy through the differentiable
        route, its head ``embed.T``. Returns (loss, {"ce": loss});
        ``local_rows``: the data shards' mean of their rows' losses, as
        ``TransformerLM.loss_fn``."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        cross = self.cross_caches(self.encode(batch["audio_embeds"],
                                              train=True))
        h, _ = self.decode_seq(tokens[:, :-1], cross, train=True)
        loss = cross_entropy(self._logits(h), tokens[:, 1:])
        if local_rows:
            loss = self.sh.mean_data(loss)
        return loss, {"ce": loss}

    # ------------------------------------------------------------ serving
    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """batch: {"audio_embeds" (B, S_enc, d), "tokens" (B, S)}. Returns
        the last token's logits (B,1,V) and the caches, the self caches
        grown to ``cache_len`` when given (a batch of 1 over several data
        shards: replicated, the self caches cut to the shard's slots, the
        cross caches whole)."""
        rows = int(batch["tokens"].shape[0])
        batch = {k: self.sh.split_rows(v) for k, v in batch.items()}
        cross = self.cross_caches(self.encode(batch["audio_embeds"]))
        h, caches = self.decode_seq(batch["tokens"], cross, with_cache=True,
                                    cache_len=cache_len,
                                    seq=self.sh.seq_parallel(rows))
        return self.sh.gather_rows(self._logits(h[:, -1:]), rows), \
            {"self": caches, "cross": cross}

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head ``embed.T`` over the normed decoder states, the whole
        vocabulary on every rank."""
        return head_logits(h, self.embed.T, self.sh, self.cfg.vocab)

    def decode_step(self, caches: Caches, batch: Dict
                    ) -> Tuple[torch.Tensor, Caches]:
        """batch: {"token": (B,1) ints, "pos": int}. Returns (logits
        (B,1,V), caches), the self caches updated in place. A position
        past the learned table takes its last row, as the reference's
        ``dynamic_slice`` clamps it."""
        cfg = self.cfg
        pos = int(batch["pos"])
        rows = int(batch["token"].shape[0])
        seq = self.sh.seq_parallel(rows)
        row = min(pos, DEC_POSITIONS - 1)
        x = embed_lookup(self.embed, self.sh.split_rows(batch["token"]),
                         self.sh, cfg.vocab) + self.dec_pos[row:row + 1]
        cross = caches["cross"]
        for i, blk in enumerate(self.dec_blocks):
            layer = {n: t[i] for n, t in caches["self"].items()}

            def attend(p, xn):
                return attn.attn_decode(p, xn, layer, pos, cfg, True,
                                        self.sh, seq=seq)[0]
            x = self._dec_block(blk, x, cross["k"][i], cross["v"][i], attend)
        x = rms_norm(x, self.dec_norm, cfg.norm_eps)
        return self.sh.gather_rows(self._logits(x), rows), caches

    def init_caches(self, batch: int, cache_len: int) -> Caches:
        """Zero caches for a batch of ``batch`` (on a mesh this data
        shard's rows and the rank's kv heads)."""
        cfg, n, sh = self.cfg, self.cfg.dec_layers, self.sh
        rows = sh.local_rows(batch)
        one = attn.init_cache(cfg, rows, cache_len, True, self.dtype,
                              self.device, sh, seq=sh.seq_parallel(batch))
        kv = attn.attn_layout(cfg, sh).kv
        shape = (n, rows, CROSS_FRAMES, kv.stop - kv.start, cfg.head_dim)
        return {"self": {k: t.expand(n, *t.shape).clone()
                         for k, t in one.items()},
                "cross": {k: torch.zeros(shape, dtype=self.dtype,
                                         device=self.device)
                          for k in ("k", "v")}}
