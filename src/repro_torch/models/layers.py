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

Sharding (ROADMAP queue A item 13b). ``P`` is a partition spec as the
reference writes one, a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (sharded over their
product, row-major); ``tuple(P(...))`` is the reference's
``tuple(PartitionSpec(...))``. Every ``*_pspec`` helper returns the
reference's specs. ``Sharding`` is one rank's place on a device mesh:
each module holds only its slice of every parameter (``Sharding.index``
of the spec), and the forward issues the collectives explicitly over the
model axis's group, where GSPMD places them in the reference
(``reduce``: partial sums; ``gather``: a dimension sharded over the
model axis; ``enter``: a replicated activation entering a sharded
product, whose gradient sums over the model axis). Without a mesh, or
with a model axis of 1, none of them issues a collective. ``he_init``
draws the whole tensor in the same slices with or without a mesh and
keeps the part ``index`` names, so a rank's weights are its slice of the
unsharded draw.

Data parallelism (item 13c). In training each data shard runs its rows
and its loss is the whole batch's (``mean_data``: the shards' mean, over
``reduce_data``, whose gradient passes to each shard's term); the train
step sums the shards' gradients. ``gather_data(sum_grad=True)`` gathers a
tensor sharded over the data axes whose gradient must sum over the
shards (a reduce-scatter). A reduced value that each rank then uses for
its own slice (RMSNorm's sum of squares over sharded channels) enters
that use through ``enter``, so its gradient sums over the model axis. A
batch of 1 over several data shards is sequence-parallel
(``seq_parallel``): the row is replicated and each shard holds its
``seq_slots`` of every KV cache.

The losses are the reference's: ``cross_entropy`` (token-mean, float32,
z-loss 1e-4, optional mask) and ``chunked_ce``, which never holds more than
one sequence chunk's float32 logits: each chunk is a
``torch.utils.checkpoint`` region, so its logits are recomputed in the
backward pass, as the reference's ``jax.checkpoint`` body does.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.collectives import all_gather, all_reduce, data_group, model_group

__all__ = ["rms_norm", "rope", "mlp_apply", "mlp_params", "init_mlp",
           "he_init", "dense_init", "embed_init", "cross_entropy",
           "chunked_ce", "remat", "DTYPES", "DRAW_SLICE", "P", "divisible",
           "embed_pspec", "mlp_pspec", "Sharding", "NO_MESH", "draw_into"]

#: ``ModelConfig.dtype`` names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: elements of one float32 draw at most (1 GiB)
DRAW_SLICE = 1 << 28


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: per tensor dimension ``None``, a mesh axis name
    or a tuple of names; equal, as a tuple, to the reference's
    ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def divisible(n: int, tp: Optional[int]) -> bool:
    """True when dimension ``n`` can shard evenly over a model axis of
    size ``tp`` (tp=None: assume yes, as the reference's unsharded
    paths)."""
    return tp is None or (tp > 0 and n % tp == 0)


def embed_pspec(vocab: int, tp: Optional[int] = None) -> P:
    """Vocab-sharded embedding when divisible; replicated otherwise."""
    return P("model", None) if divisible(vocab, tp) else P(None, None)


def mlp_pspec(act: str, d_ff: int = 0, tp: Optional[int] = None
              ) -> Dict[str, P]:
    """Column-parallel ``wi``/``wg`` and row-parallel ``wo`` when ``d_ff``
    divides the model axis; else the swap: ``wi``/``wg`` sharded on their
    ``d_model`` contraction and ``wo`` on its output."""
    ok = d_ff == 0 or divisible(d_ff, tp)
    hid = P(None, "model") if ok else P("model", None)
    out = P("model", None) if ok else P(None, "model")
    if act in ("swiglu", "geglu"):
        return {"wi": hid, "wg": hid, "wo": out}
    return {"wi": hid, "wo": out}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class _Reduce(torch.autograd.Function):
    """Partial sums -> their sum on every rank; the gradient passes as it
    is (every rank's loss is the one global loss)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Identity; the gradient sums over the group (a replicated activation
    feeding each rank's slice of a sharded product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """Every rank's slice concatenated along ``dim``; the gradient keeps
    this rank's slice (``sum_grad``: of the gradient summed over the
    group, a reduce-scatter, where each rank's gradient is its own rows'
    part of the whole)."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, sum_grad=False):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        ctx.group, ctx.sum_grad = group, sum_grad
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = all_reduce(g, ctx.group)
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None,
                None)


class Sharding:
    """One rank's place on a device mesh (``launch.mesh``) for a model:
    the model axis's size ``tp`` and this rank's coordinate ``rank`` on
    it, the data shards ``n_data`` (every axis of ``data_axes``) and this
    rank's ``data_rank``, and the collectives of a sharded forward.
    ``Sharding(None)`` (``NO_MESH``) is the unsharded model: full slices,
    no collective."""

    def __init__(self, mesh=None, data_axes: Sequence[str] = ("data",),
                 model_axis: str = "model"):
        self.mesh, self.data_axes = mesh, tuple(data_axes)
        self.model_axis = model_axis
        self.sizes: Dict[str, int] = {}
        self.coord: Dict[str, int] = {}
        if mesh is not None:
            names = mesh.mesh_dim_names
            self.sizes = {a: int(mesh.shape[i]) for i, a in enumerate(names)}
            c = mesh.get_coordinate()
            if c is None:
                raise ValueError("this rank is not on the model's mesh")
            self.coord = {a: int(c[i]) for i, a in enumerate(names)}
        self.tp = self.sizes.get(model_axis, 1)
        self.rank = self.coord.get(model_axis, 0)
        self.n_data = math.prod(self.sizes.get(a, 1) for a in self.data_axes)
        self.data_rank = 0
        for a in self.data_axes:
            self.data_rank = self.data_rank * self.sizes.get(a, 1) \
                + self.coord.get(a, 0)

    @property
    def spec_tp(self) -> Optional[int]:
        """The reference's ``mesh_tp``: the model axis's size, ``None``
        without a mesh or without a model axis."""
        return self.sizes.get(self.model_axis)

    def group(self):
        return model_group(self.mesh, self.model_axis)

    def data_group(self):
        return data_group(self.mesh, self.data_axes)

    # -------------------------------------------------------- specs
    def part(self, entry) -> Tuple[int, int]:
        """(index, count) of this rank along a spec entry's axes."""
        i, n = 0, 1
        for a in _axes(entry):
            size = self.sizes.get(a, 1)
            i, n = i * size + self.coord.get(a, 0), n * size
        return i, n

    def index(self, spec: Sequence, shape: Sequence[int]
              ) -> Tuple[slice, ...]:
        """This rank's slice of a ``shape`` tensor laid out by ``spec``
        (an entry per dimension; fewer entries leave the rest whole)."""
        out = []
        for d, size in enumerate(shape):
            i, n = self.part(spec[d] if d < len(spec) else None)
            if size % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split {n} ways (spec {spec})")
            out.append(slice(i * (size // n), (i + 1) * (size // n)))
        return tuple(out)

    def local_shape(self, spec: Sequence, shape: Sequence[int]
                    ) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index(spec, shape))

    # -------------------------------------------------- collectives
    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the model axis's partial ``x``."""
        return _Reduce.apply(x, self.group()) if self.tp > 1 else x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated over the model axis) as the input of a sharded
        product: the identity, its gradient summed over the axis."""
        return _Enter.apply(x, self.group()) if self.tp > 1 else x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` sharded along ``dim`` over the model axis, whole."""
        if self.tp == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.group(), self.rank)

    def gather_data(self, x: torch.Tensor, dim: int,
                    axes: Tuple[str, ...], sum_grad: bool = False
                    ) -> torch.Tensor:
        """``x`` sharded along ``dim`` over the data ``axes``, whole; the
        gradient keeps this rank's slice (with ``sum_grad`` of the
        gradient summed over ``axes``: each data shard saw its own rows)."""
        i, n = self.part(axes)
        if n == 1:
            return x
        return _Gather.apply(x, dim % x.dim(),
                             data_group(self.mesh, tuple(axes)), i, sum_grad)

    def reduce_data(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data shards; the gradient passes as
        it is to each shard's term (every shard's loss is the one global
        loss, and the train step sums the shards' gradients)."""
        if self.n_data == 1:
            return x
        return _Reduce.apply(x, self.data_group())

    def mean_data(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of the data shards' ``x`` (``reduce_data`` / shards):
        a loss over equal shares of the rows, each shard's a mean."""
        return x if self.n_data == 1 else self.reduce_data(x) / self.n_data

    # ------------------------------------------------------- rows
    def seq_parallel(self, batch: int) -> bool:
        """A batch of 1 over more than one data shard: the row is
        replicated and a cache's sequence is split over the data shards
        instead (the reference's ``shard_seq``)."""
        return batch == 1 and self.n_data > 1

    def local_rows(self, batch: int) -> int:
        """This data shard's rows of a batch of ``batch`` (a batch of 1:
        the row, on every shard)."""
        if self.n_data == 1 or batch == 1:
            return batch
        if batch % self.n_data:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{self.n_data} data shards")
        return batch // self.n_data

    def split_rows(self, x):
        """This data shard's rows of a batched input (``batch_pspecs``:
        batch on the data axes; a batch of 1 replicated), any array; a
        scalar as it is."""
        if self.n_data == 1 or getattr(x, "ndim", 0) == 0 \
                or x.shape[0] == 1:
            return x
        per = self.local_rows(x.shape[0])
        return x[self.data_rank * per:(self.data_rank + 1) * per]

    def gather_rows(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """Every data shard's rows of ``x``, in data order, for a batch of
        ``batch`` rows (a batch of 1 is on every shard already)."""
        if self.n_data == 1 or batch == 1:
            return x
        return all_gather(x, 0, self.data_group())

    def seq_slots(self, slots: int) -> slice:
        """This data shard's part ``[r·slots/n, (r+1)·slots/n)`` of a
        cache's ``slots`` in sequence-parallel decode."""
        if slots % self.n_data:
            raise ValueError(f"a cache of {slots} slots does not split over "
                             f"{self.n_data} data shards")
        c = slots // self.n_data
        return slice(self.data_rank * c, (self.data_rank + 1) * c)


NO_MESH = Sharding(None)


def merge_index(index: Sequence[slice], shape: Sequence[int],
                groups: Sequence[int]) -> Tuple[slice, ...]:
    """``index`` on ``shape`` as an index on the shape whose dimensions
    merge ``groups`` consecutive ones of ``shape`` each (e.g. ``(d, h,
    hd)`` drawn as ``(d, h·hd)``: groups ``(1, 2)``). Within a group only
    the first dimension may be sliced."""
    out, d = [], 0
    for g in groups:
        inner = math.prod(shape[d + 1:d + g])
        for j in range(d + 1, d + g):
            if (index[j].start, index[j].stop) != (0, shape[j]):
                raise ValueError(f"cannot merge {index} over {shape}")
        out.append(slice(index[d].start * inner, index[d].stop * inner))
        d += g
    return tuple(out)


def he_init(gen: torch.Generator, shape: Tuple[int, ...],
            fan_in: Optional[int] = None,
            dtype: torch.dtype = torch.float32,
            out: Optional[torch.Tensor] = None,
            index: Optional[Sequence[slice]] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in float32 on ``gen``'s device, cast to
    ``dtype`` (or written into ``out``), in slices of at most
    ``DRAW_SLICE`` elements along the leading axis. With ``index`` (slices
    of ``shape``) only that part is kept (``out`` has its shape): the
    whole tensor is drawn in the same slices, so the part is the
    unsharded draw's."""
    fan_in = fan_in or shape[0]
    index = tuple(index) if index is not None \
        else tuple(slice(0, n) for n in shape)
    if out is None:
        out = torch.empty(tuple(s.stop - s.start for s in index),
                          dtype=dtype, device=gen.device)
    lo, hi = index[0].start, index[0].stop
    rows = max(1, DRAW_SLICE // max(1, math.prod(shape[1:])))
    for r in range(0, shape[0], rows):
        n = min(rows, shape[0] - r)
        x = torch.randn((n, *shape[1:]), generator=gen, dtype=torch.float32,
                        device=gen.device)
        a, b = max(lo, r), min(hi, r + n)
        if a < b:
            part = x[(slice(a - r, b - r),) + index[1:]]
            out[a - lo:b - lo].copy_(part.mul_(1.0 / math.sqrt(fan_in)))
    return out


def draw_into(gen: torch.Generator, w: torch.Tensor,
              draw: Tuple[int, ...], fan_in: int,
              index: Optional[Sequence[slice]] = None,
              transpose: bool = False) -> None:
    """Fill ``w`` (a rank's slice of a tensor whose reference draw has
    shape ``draw``) with ``he_init``'s draw: ``index`` is ``w``'s slice of
    the draw (its dimensions merged as the draw's, see ``merge_index``);
    with ``transpose`` ``w`` holds the transpose of a 2-D draw."""
    out = torch.empty(tuple(s.stop - s.start for s in index) if index
                      else draw, dtype=w.dtype, device=w.device)
    he_init(gen, draw, fan_in, w.dtype, out=out, index=index)
    w.copy_((out.T if transpose else out).reshape(w.shape))


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    return he_init(gen, (d_in, d_out), d_in, dtype, out)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    return he_init(gen, (vocab, d), d, dtype, out)


def _mlp_full(d: int, ff: int) -> Dict[str, Tuple[int, int]]:
    return {"wi": (d, ff), "wo": (ff, d), "wg": (d, ff)}


def mlp_params(d: int, ff: int, act: str, dtype: torch.dtype,
               device: torch.device, sh: Sharding = NO_MESH
               ) -> nn.ParameterDict:
    """An MLP's ``{wi, wo[, wg]}`` in the reference's layouts (this rank's
    slices of ``mlp_pspec``'s on a mesh), allocated, not initialised
    (``init_mlp`` fills them)."""
    spec, full = mlp_pspec(act, ff, sh.spec_tp), _mlp_full(d, ff)
    return nn.ParameterDict({
        n: nn.Parameter(torch.empty(sh.local_shape(spec[n], full[n]),
                                    dtype=dtype, device=device),
                        requires_grad=False)
        for n in ("wi", "wo", "wg") if n in spec})


@torch.no_grad()
def init_mlp(p: nn.ParameterDict, gen: torch.Generator, d: int, ff: int,
             act: str, sh: Sharding = NO_MESH) -> None:
    """He-normal ``wi``, ``wo`` and ``wg`` from ``gen``, in that order
    (a rank keeps its slices of the whole draws)."""
    spec, full = mlp_pspec(act, ff, sh.spec_tp), _mlp_full(d, ff)
    for n, w in p.items():
        draw_into(gen, w, full[n], full[n][0], sh.index(spec[n], full[n]))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             sh: Optional["Sharding"] = None, width: int = 0
             ) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + scale`` (scales start at zero),
    cast back to x's dtype. With ``sh`` (tp > 1) ``x`` and ``scale`` hold
    the rank's slice of rows ``width`` wide: the sum of squares is summed
    over the model axis (and, as each rank normalises its own slice with
    it, so is its gradient)."""
    dt = x.dtype
    x = x.float()
    if sh is None or sh.tp == 1:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = sh.enter(sh.reduce(x.square().sum(dim=-1, keepdim=True))) \
            / width
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


def _hidden(act: str, proj) -> torch.Tensor:
    """The MLP's hidden activation from ``proj(name)``, the input's
    product with ``wi`` or ``wg``."""
    if act == "swiglu":
        return F.silu(proj("wg")) * proj("wi")
    if act == "geglu":
        return F.gelu(proj("wg"), approximate="tanh") * proj("wi")
    if act == "gelu":
        return F.gelu(proj("wi"), approximate="tanh")
    raise ValueError(f"unknown act {act}")


def mlp_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, act: str,
              sh: Sharding = NO_MESH, d_ff: int = 0) -> torch.Tensor:
    """swiglu / geglu (tanh GELU) gated MLP, or an ungated tanh-GELU MLP.
    On a mesh (``sh``, the layout of ``mlp_pspec(act, d_ff)``): column-
    then row-parallel with one sum of the partial outputs; in the swap
    layout the hidden products' partial sums are summed before the
    activation and the output's ``d_model`` slices gathered."""
    if sh.tp == 1:
        return _hidden(act, lambda n: x @ p[n]) @ p["wo"]
    if divisible(d_ff, sh.spec_tp):
        xe = sh.enter(x)
        return sh.reduce(_hidden(act, lambda n: xe @ p[n]) @ p["wo"])
    d = p["wi"].shape[0]
    xs = sh.enter(x)[..., sh.rank * d:(sh.rank + 1) * d]
    h = _hidden(act, lambda n: sh.reduce(xs @ p[n]))
    return sh.gather(sh.enter(h) @ p["wo"], -1)


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
