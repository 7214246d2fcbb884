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

On a device mesh (``layers.Sharding``) a rank holds its slices of
``attn_pspec``'s layout and attends its own heads (``attn_layout``):

* q heads divide the model axis: the rank's ``H/tp`` q heads and, when
  the kv heads divide too, its ``K/tp`` kv heads, the GQA group ``G``
  unchanged; B3 and B4 run on those local heads. The output projection's
  partial sums are summed over the model axis.
* kv heads do not divide (``wk``, ``wv`` replicated): the rank projects
  and caches only the kv heads its q heads read, ``[q0 // G, (q1-1) //
  G]``. Where each of them serves the same number of the rank's q heads
  the kernels take them as groups of that size; otherwise each q head gets
  its kv head's copy (groups of 1). The reference's cache spec shards
  ``head_dim`` instead, which B4 could not attend without a reduction
  inside the softmax: a rank here holds ``K_local · tp / K`` times the
  reference's per-device cache (qwen3 at tp 16: one kv head of 8, twice
  the reference's ``hd/16`` of all 8).
* q heads do not divide either (arctic's 56 on 16): partial-sum TP over
  the ``d_model`` contraction. The rank's ``wq`` rows give a partial q,
  summed over the model axis; every rank then attends all heads against
  the whole (replicated) kv and keeps the whole cache, and its ``wo``
  columns give its ``d_model`` slice of the output, gathered over the
  axis.

Without a mesh (or with a model axis of 1) nothing here issues a
collective and the arithmetic is the unsharded model's.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.collectives import all_gather
from ..kernels import ops as kops
from .layers import NO_MESH, P, Sharding, divisible, rms_norm, rope

__all__ = ["attn_prefill", "attn_decode", "grow_cache", "init_cache",
           "quantize_kv", "dequantize_kv", "cross_attn_apply", "cross_kv",
           "NEG_INF", "attn_pspec", "cache_pspec", "attn_layout",
           "AttnLayout", "attn_full_shapes", "seq_combine"]

NEG_INF = -2.0 ** 30   # large-but-finite, as in the reference

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

def attn_pspec(cfg: ModelConfig, tp: Optional[int] = None) -> Dict[str, P]:
    """The reference's tensor-parallel layout with its fallbacks: q heads
    on "model" when they divide it, else the ``d_model`` contraction
    (partial-sum TP); kv heads on "model" when they divide it, else
    replicated."""
    q_ok = divisible(cfg.n_heads, tp)
    kv_ok = divisible(cfg.n_kv_heads, tp)
    p = {
        "wq": P(None, "model", None) if q_ok else P("model", None, None),
        "wk": P(None, "model", None) if kv_ok else P(None, None, None),
        "wv": P(None, "model", None) if kv_ok else P(None, None, None),
        "wo": P("model", None, None) if q_ok else P(None, None, "model"),
    }
    if cfg.qk_norm:
        p["q_norm"] = P(None)
        p["k_norm"] = P(None)
    return p


def cache_pspec(batch_axes, shard_seq: bool, kv_ok: bool = True,
                quantized: bool = False) -> Dict[str, P]:
    """The reference's cache spec (B, S, K, hd): batch on the data axes
    (``shard_seq``: the sequence instead), kv heads on "model" when they
    divide it, else ``head_dim``; int8 scales' trailing 1 never shards.
    Where ``kv_ok`` is false a rank's cache departs from it (see the
    module's docstring)."""
    kh, hd = ("model", None) if kv_ok else (None, "model")
    if shard_seq:
        spec = P(None, batch_axes, kh, hd)
        sspec = P(None, batch_axes, kh, None)
    else:
        spec = P(batch_axes, None, kh, hd)
        sspec = P(batch_axes, None, kh, None)
    if quantized:
        return {"k": spec, "k_s": sspec, "v": spec, "v_s": sspec}
    return {"k": spec, "v": spec}


def attn_full_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"wq": (d, h, hd), "wk": (d, k, hd), "wv": (d, k, hd),
           "wo": (h, hd, d)}
    if cfg.qk_norm:
        out["q_norm"] = out["k_norm"] = (hd,)
    return out


class AttnLayout(NamedTuple):
    """A rank's share of an attention layer: its q heads ``heads`` and the
    kv heads ``kv`` it projects and caches (slices of the layer's), the
    GQA group ``g`` the kernels see, ``sel`` (each local q head's kv head
    within ``kv``, when the groups are not even) and ``partial`` (the
    partial-sum layout: all heads, ``d_model`` sharded)."""
    heads: slice
    kv: slice
    g: int
    sel: Optional[Tuple[int, ...]]
    partial: bool
    kv_sharded: bool


def attn_layout(cfg: ModelConfig, sh: Sharding = NO_MESH) -> AttnLayout:
    h, k = cfg.n_heads, cfg.n_kv_heads
    g = h // k
    tp = sh.spec_tp
    if sh.tp == 1:
        return AttnLayout(slice(0, h), slice(0, k), g, None, False, False)
    if not divisible(h, tp):
        return AttnLayout(slice(0, h), slice(0, k), g, None, True, False)
    heads = sh.index(P("model"), (h,))[0]
    if divisible(k, tp):
        return AttnLayout(heads, sh.index(P("model"), (k,))[0], g, None,
                          False, True)
    kv = slice(heads.start // g, (heads.stop - 1) // g + 1)
    own = [q // g - kv.start for q in range(heads.start, heads.stop)]
    n_q, n_kv = len(own), kv.stop - kv.start
    if n_q % n_kv == 0 and own == [i // (n_q // n_kv) for i in range(n_q)]:
        return AttnLayout(heads, kv, n_q // n_kv, None, False, False)
    return AttnLayout(heads, kv, 1, tuple(own), False, False)


def _expand(t: torch.Tensor, lay: AttnLayout, dim: int) -> torch.Tensor:
    """The kv heads of ``t`` (along ``dim``) as the kernels see them: as
    they are, or one per local q head (``lay.sel``)."""
    if lay.sel is None:
        return t
    return t.index_select(dim, torch.tensor(lay.sel, device=t.device))


def _project_qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig,
                 sh: Sharding = NO_MESH
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,K,hd), with qk-norm + RoPE;
    on a mesh the rank's heads (``attn_layout``): q's partial sums summed
    in the partial-sum layout."""
    lay = attn_layout(cfg, sh)
    if sh.tp == 1:
        xq = xk = x
        wq, wk, wv = p["wq"], p["wk"], p["wv"]
        qn, kn = p.get("q_norm"), p.get("k_norm")
    elif lay.partial:
        d = p["wq"].shape[0]
        xq = sh.enter(x)[..., sh.rank * d:(sh.rank + 1) * d]
        xk, wq, wk, wv = x, p["wq"], p["wk"], p["wv"]
        qn, kn = p.get("q_norm"), p.get("k_norm")
    else:
        xq = xk = sh.enter(x)
        wq = p["wq"]
        wk, wv = p["wk"], p["wv"]
        if not lay.kv_sharded:          # replicated: keep the rank's heads
            wk, wv = (sh.enter(w)[:, lay.kv] for w in (wk, wv))
        qn, kn = (sh.enter(p[n]) if n in p else None
                  for n in ("q_norm", "k_norm"))
    q = torch.einsum("bsd,dhq->bshq", xq, wq)
    if lay.partial:
        q = sh.reduce(q)
    k = torch.einsum("bsd,dkq->bskq", xk, wk)
    v = torch.einsum("bsd,dkq->bskq", xk, wv)
    if cfg.qk_norm:
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    if cfg.head_dim:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor, lay: AttnLayout,
              sh: Sharding) -> torch.Tensor:
    """(B,S,h,hd) attention output through ``wo``: on a mesh the rank's
    partial sum summed over the model axis, or in the partial-sum layout
    its ``d_model`` columns gathered."""
    y = torch.einsum("bshq,hqd->bsd", sh.enter(out) if lay.partial else out,
                     wo)
    if sh.tp == 1:
        return y
    return sh.gather(y, -1) if lay.partial else sh.reduce(y)


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


def _attend_shape(q: torch.Tensor, kv: torch.Tensor, lay: AttnLayout
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(q as (..., K', G', hd), kv's head count K', G') for the kernels:
    the rank's kv heads in groups of ``lay.g``, or one per q head."""
    h = q.shape[-2]
    kh = h if lay.sel is not None else kv.shape[-2]
    return q.reshape(*q.shape[:-2], kh, h // kh, q.shape[-1]), kh, h // kh


def attn_prefill(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig, is_global: bool,
                 with_cache: bool = False, causal: bool = True,
                 train: bool = False, sh: Sharding = NO_MESH
                 ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Causal (or sliding-window, or bidirectional) self-attention over a
    full sequence. Returns (out (B,S,D), cache or None); a sliding-window
    layer's cache keeps the last ``window`` roped keys and values. B3 runs
    it, or with ``train`` the differentiable ``_chunked_attention``; on a
    mesh over the rank's heads (the cache: its kv heads)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    lay = attn_layout(cfg, sh)
    q, k, v = _project_qkv(p, x, positions, cfg, sh)
    h = q.shape[2]
    window = 0 if is_global else cfg.window
    attend = _chunked_attention if train else kops.flash_attention
    q5, _, _ = _attend_shape(q, k, lay)
    out = attend(q5, _expand(k, lay, 2), _expand(v, lay, 2), causal=causal,
                 window=window)
    out = out.reshape(b, s, h, hd).to(x.dtype)
    y = _out_proj(out, p["wo"], lay, sh)
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
               cache_len: int, prefill_len: int, sh: Sharding = NO_MESH,
               seq: bool = False) -> Cache:
    """Grow a prefill-produced cache to its serving capacity: global caches
    are zero-padded to ``cache_len``; ring caches are rolled so slot
    ``p % window`` holds position ``p``. With ``seq`` (sequence-parallel
    decode of a batch of 1) only the data shard's slots ``[r·C/n,
    (r+1)·C/n)`` of the grown cache are made, written straight from the
    prefill's, so no rank holds the whole grown cache. The sequence axis
    is the third from the end (of values and int8 scales alike), so
    layer-stacked caches grow as well."""
    w = 0 if (is_global or not cfg.window) else cfg.window
    tgt = min(w, cache_len) if w else cache_len

    def fix(a: torch.Tensor) -> torch.Tensor:
        axis = a.dim() - 3
        cur = a.shape[axis]
        rolled = bool(w) and prefill_len >= w
        cap = cur if rolled else max(tgt, cur)
        own = sh.seq_slots(cap) if seq else slice(0, cap)
        if rolled:          # slot j holds position p with p % w == j
            if not seq:
                return torch.roll(a, prefill_len % w, dims=axis)
            idx = torch.arange(own.start, own.stop, device=a.device)
            return a.index_select(axis, (idx - prefill_len) % w)
        if own == slice(0, cur):
            return a
        shape = list(a.shape)
        shape[axis] = own.stop - own.start
        out = a.new_zeros(shape)
        n = min(own.stop, cur) - own.start
        if n > 0:
            out.narrow(axis, 0, n).copy_(a.narrow(axis, own.start, n))
        return out

    return {name: fix(a) for name, a in cache.items()}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               is_global: bool, dtype: torch.dtype,
               device: torch.device, sh: Sharding = NO_MESH,
               seq: bool = False) -> Cache:
    """A zero cache of ``batch`` rows; on a mesh of the rank's kv heads
    (``attn_layout``), and with ``seq`` of its data shard's slots."""
    eff = cache_len if (is_global or not cfg.window) \
        else min(cfg.window, cache_len)
    if seq:
        sl = sh.seq_slots(eff)
        eff = sl.stop - sl.start
    kv = attn_layout(cfg, sh).kv
    shape = (batch, eff, kv.stop - kv.start, cfg.head_dim)
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


def seq_combine(o: torch.Tensor, lse: torch.Tensor, sh: Sharding,
                dtype: torch.dtype) -> torch.Tensor:
    """Merge the data shards' attention over their own slots: ``o`` (...,
    hd) and its log-sum-exp ``lse`` (...) from every shard, ``M = max_r
    lse_r``, ``o = Σ_r e^(lse_r − M) o_r / Σ_r e^(lse_r − M)`` in float32
    (a shard with no live slot sends ``o = 0``, ``lse = −inf``), cast to
    ``dtype``. Every shard gets the same tensor, from one all-gather of
    ``o`` with ``lse`` as its last column."""
    both = all_gather(torch.cat([o.float(), lse.float()[..., None]],
                                dim=-1)[None], 0, sh.data_group())
    os_, ls = both[..., :-1], both[..., -1]
    w = torch.exp(ls - ls.amax(dim=0))
    return ((w[..., None] * os_).sum(dim=0)
            / w.sum(dim=0)[..., None]).to(dtype)


def attn_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cache: Cache, pos: int, cfg: ModelConfig, is_global: bool,
                sh: Sharding = NO_MESH, seq: bool = False
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. x: (B,1,D); cache k/v: (B,C,K,hd); pos: the
    number of tokens already in the cache (one for the whole batch).

    The new k/v (quantized, with its scales, in an int8 cache) goes to slot
    ``pos``, or ``pos % C`` in a ring cache (C == window), in place; slots
    [0, valid_len) are attended. On a mesh: the rank's heads. With
    ``seq`` (sequence-parallel decode of a batch of 1) the cache holds the
    data shard's ``C/n`` slots ``[r·C/n, (r+1)·C/n)``: the shard owning
    the slot writes it, each shard attends its live slots, and the
    shards' outputs are merged by their log-sum-exps (``seq_combine``).
    """
    b = x.shape[0]
    hd = cfg.head_dim
    lay = attn_layout(cfg, sh)
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg, sh)
    h = q.shape[2]
    c = cache["k"].shape[1]
    lo = sh.data_rank * c if seq else 0
    c_all = c * sh.n_data if seq else c
    window = 0 if is_global else cfg.window
    ring = bool(window) and window == c_all
    slot = (pos % c_all if ring else pos) - lo
    if 0 <= slot < c:
        if "k_s" in cache:
            for name, t in (("k", k_new), ("v", v_new)):
                qt, st = quantize_kv(t)
                cache[name][:, slot] = qt[:, 0]
                cache[f"{name}_s"][:, slot] = st[:, 0]
        else:
            cache["k"][:, slot] = k_new[:, 0]
            cache["v"][:, slot] = v_new[:, 0]
    # ring layout: every written slot holds one of the last `window`
    # positions, so slots [0, min(pos+1, c)) are live; linear: [0, pos+1)
    valid_len = min(pos + 1, c_all) if ring else pos + 1
    valid = min(max(valid_len - lo, 0), c)
    q4, kh, g = _attend_shape(q[:, 0], cache["k"], lay)
    if valid:
        if "k_s" in cache:
            k = dequantize_kv(cache["k"], cache["k_s"], x.dtype)
            v = dequantize_kv(cache["v"], cache["v_s"], x.dtype)
        else:
            k, v = cache["k"], cache["v"]
        args = (q4, _expand(k, lay, 2), _expand(v, lay, 2), valid)
        o = kops.decode_attention(*args, return_lse=True) if seq \
            else kops.decode_attention(*args)
    if seq:
        if valid:
            o, lse = o
        else:              # no live slot here: weighs nothing in the merge
            o = torch.zeros_like(q4)
            lse = torch.full((b, kh, g), -torch.inf, dtype=torch.float32,
                             device=x.device)
        o = seq_combine(o, lse, sh, x.dtype)
    y = _out_proj(o.to(x.dtype).reshape(b, 1, h, hd), p["wo"], lay, sh)
    return y, cache


def cross_attn_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                     enc_k: torch.Tensor, enc_v: torch.Tensor,
                     cfg: ModelConfig, sh: Sharding = NO_MESH
                     ) -> torch.Tensor:
    """x: (B,S,D) queries; enc_k/enc_v: (B,Se,K,hd) precomputed from the
    encoder output (no mask, no RoPE on the cross path); on a mesh the
    rank's heads, its kv heads from ``cross_kv``."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    lay = attn_layout(cfg, sh)
    if lay.partial:
        d = p["wq"].shape[0]
        q = sh.reduce(torch.einsum(
            "bsd,dhq->bshq",
            sh.enter(x)[..., sh.rank * d:(sh.rank + 1) * d], p["wq"]))
    else:
        q = torch.einsum("bsd,dhq->bshq", sh.enter(x), p["wq"])
    h = q.shape[2]
    q5, _, _ = _attend_shape(q, enc_k, lay)
    out = _chunked_attention(q5, _expand(enc_k, lay, 2),
                             _expand(enc_v, lay, 2)).reshape(b, s, h, hd)
    return _out_proj(out.to(x.dtype), p["wo"], lay, sh)


def cross_kv(p: Mapping[str, torch.Tensor], enc_out: torch.Tensor,
             cfg: Optional[ModelConfig] = None, sh: Sharding = NO_MESH
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's cross-attention keys and values (B,Se,K,hd);
    on a mesh (``cfg`` given) the rank's kv heads."""
    wk, wv = p["wk"], p["wv"]
    lay = attn_layout(cfg, sh) if sh.tp > 1 else None
    if lay is not None and not lay.partial:   # partial: every kv head
        enc_out = sh.enter(enc_out)
        if not lay.kv_sharded:
            wk, wv = (sh.enter(w)[:, lay.kv] for w in (wk, wv))
    return (torch.einsum("bsd,dkq->bskq", enc_out, wk),
            torch.einsum("bsd,dkq->bskq", enc_out, wv))
