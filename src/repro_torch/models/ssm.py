"""Mamba2 (SSD, state-space duality) blocks — the port of
``repro/models/ssm.py`` for serving.

The block follows Mamba2 (arXiv:2405.21060): input projections into
(z, x, B, C, dt), a causal depthwise conv over (x, B, C), silu, the
selective SSM with a scalar decay per head, gated RMSNorm, out projection.

The sequence path uses the chunked SSD algorithm: within chunks of
``cfg.ssm_chunk`` the recurrence is a decay-masked quadratic form, computed
by ``kernels.ops.ssd_intra`` (kernel B5 on the card, its plain version on
the CPU: the tensors' device picks), or for training (``train=True``,
passed by the models' ``loss_fn`` only) by the reference's differentiable
einsum form, whatever the device; across chunks a Python loop carries
the (heads, head_dim, state) recurrent state, in place of the reference's
``lax.scan``. ``ssd_sequential`` is the O(S)-step recurrence, the oracle of
the tests.

With a process-global telemetry (``core.telemetry.telemetry_scope``) the
block opens spans, read by the benchmark's attribution of device time by
launch: ``mamba.seq`` (the sequence block), ``ssd.chunked`` (``chunks``,
``q``) and inside it ``ssd.intra`` (B5), ``ssd.outflow``,
``ssd.chunk_loop`` and ``ssd.inflow``; ``mamba.state`` (the decode step's
state update and read-out). Without one each is a shared ``nullcontext``.

On a device mesh (``layers.Sharding``) a block holds its slices of
``mamba_pspec``'s layout when the heads and ``d_inner`` divide the model
axis (else every rank runs the whole block): the rank's ``d_inner / tp``
channels of z and x, its ``ssm_heads / tp`` heads of dt, ``A_log``, ``D``,
``dt_bias`` and the gated norm's scale, and ``wo``'s matching rows; B, C
and the conv weights are replicated. The conv runs over the rank's x
channels and the whole B and C (``conv_w``'s x columns sliced per rank),
B5 over the rank's heads, the gated norm's sum of squares is summed over
the model axis (it normalises all of ``d_inner``), and ``wo``'s partial
outputs are summed. A rank's conv state is ``(B, k-1, d_inner/tp + 2N)``,
its x channels then the whole B and C: the reference's spec ``P(batch,
None, "model")`` splits the concatenated ``d_inner + 2N`` channels
instead, which no rank's conv could read. The SSM state is the rank's
heads, as the reference's ``P(batch, "model", None, None)``.

Parameters are a dict of tensors in the reference's layouts: ``wz, wx
(d, d_inner)``, ``wB, wC (d, N)``, ``wdt (d, H)``, ``conv_w (k, d_inner +
2N)``, ``conv_b``, ``norm (d_inner,)``, ``wo (d_inner, d)`` in the model
dtype, and ``A_log, D, dt_bias (H,)`` in float32 whatever the model dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.telemetry import get_telemetry, maybe_span
from ..kernels import ops as kops
from ..kernels.ssd_scan import ssd_intra_plain
from .layers import NO_MESH, P, Sharding, divisible, draw_into, rms_norm

__all__ = ["mamba_init", "mamba_seq", "mamba_decode", "init_ssm_state",
           "ssd_chunked", "ssd_sequential", "mamba_pspec",
           "ssm_state_pspec", "mamba_shapes", "mamba_sharding"]

Params = Dict[str, torch.Tensor]
States = Tuple[torch.Tensor, torch.Tensor]


def mamba_pspec(cfg: ModelConfig, tp: Optional[int] = None
                ) -> Dict[str, P]:
    """The reference's layout: heads and ``d_inner`` on "model" when both
    divide it, else replicated; B, C and the conv replicated."""
    ok = divisible(cfg.ssm_heads, tp) and divisible(cfg.d_inner, tp)
    h = "model" if ok else None
    return {
        "wz": P(None, h), "wx": P(None, h),
        "wB": P(None, None), "wC": P(None, None),
        "wdt": P(None, h),
        "conv_w": P(None, None), "conv_b": P(None),
        "A_log": P(h), "D": P(h), "dt_bias": P(h),
        "norm": P(h), "wo": P(h, None),
    }


def ssm_state_pspec(batch_axes, replicate_batch: bool = False
                    ) -> Tuple[P, P]:
    """The reference's (conv_state, ssm_state) specs (batch 1 replicated).
    A rank's conv state departs from the first (see the module's
    docstring)."""
    ba = None if replicate_batch else batch_axes
    return (P(ba, None, "model"),
            P(ba, "model", None, None))


def mamba_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's unsharded shape."""
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"wz": (d, din), "wx": (d, din), "wB": (d, n), "wC": (d, n),
            "wdt": (d, h), "conv_w": (cfg.ssm_conv, din + 2 * n),
            "conv_b": (din + 2 * n,), "A_log": (h,), "D": (h,),
            "dt_bias": (h,), "norm": (din,), "wo": (din, d)}


def mamba_sharding(cfg: ModelConfig, sh: Sharding) -> Sharding:
    """``sh`` where the block is sharded over its model axis, else the
    unsharded ``NO_MESH`` (every rank runs the whole block)."""
    return sh if sh.tp > 1 and mamba_pspec(cfg, sh.spec_tp)["wz"][1] \
        else NO_MESH


@torch.no_grad()
def mamba_init(p: Params, gen: torch.Generator, cfg: ModelConfig,
               sh: Sharding = NO_MESH) -> None:
    """He-normal projections and conv from ``gen`` (on its device), drawn
    into ``p`` (on a mesh each rank keeps its slices of the whole draws);
    zero conv bias and norm scale; ``A = -exp(A_log) = -1``, ``D = 1`` and
    ``dt_bias = -2`` (softplus ~0.13), as the reference initialises them."""
    spec, full = mamba_pspec(cfg, sh.spec_tp), mamba_shapes(cfg)
    for name in ("wz", "wx", "wB", "wC", "wdt", "conv_w", "wo"):
        draw_into(gen, p[name], full[name], full[name][0],
                  sh.index(spec[name], full[name]))
    p["conv_b"].zero_()
    p["A_log"].zero_()
    p["D"].fill_(1.0)
    p["dt_bias"].fill_(-2.0)
    p["norm"].zero_()


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_sequential(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(S)-step recurrence (oracle). xdt: (b,s,h,p) inputs times dt;
    a: (b,s,h) per-step decay exp(dt·A); B, C: (b,s,n). Returns
    (y (b,s,h,p), final state (b,h,p,n)), in float32."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    hst = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device) \
        if h0 is None else h0.float()
    xdt, a, B, C = xdt.float(), a.float(), B.float(), C.float()
    ys = []
    for t in range(s):
        hst = hst * a[:, t, :, None, None] \
            + xdt[:, t, :, :, None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hst, C[:, t]))
    return torch.stack(ys, 1), hst


def _intra_einsum(xc: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
                  Cc: torch.Tensor) -> torch.Tensor:
    """The reference's einsum form of the intra-chunk term
    (``ssm.py:145-155``: a lower-triangular decay ``where``, the scores
    ``C·B``, their product contracted with x), differentiable. It is B5's
    plain version over the folded ``(b·c, ...)`` layout, whose two
    two-operand contractions stand in for the three-operand einsum. Its
    gradient stays finite where a steep decay overflows ``exp`` above the
    diagonal; the reference's is NaN there (ROADMAP queue C)."""
    b, c, q, h, p = xc.shape
    n = Bc.shape[-1]
    return ssd_intra_plain(xc.reshape(b * c, q, h, p),
                           cum.reshape(b * c, q, h), Bc.reshape(b * c, q, n),
                           Cc.reshape(b * c, q, n)).reshape(b, c, q, h, p)


def ssd_chunked(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Same contract as ``ssd_sequential``.

    Per chunk c of length Q (cum = inclusive cumsum of log a):
      intra[i] = Σ_{j≤i} (C_i·B_j) · exp(cum_i − cum_j) · xdt_j   (B5, or
                 with ``train`` the einsum form)
      state_c  = Σ_j exp(cum_Q − cum_j) · B_j ⊗ xdt_j            (outflow)
      inter[i] = exp(cum_i) · C_i · S_{c-1};  S_c = exp(cum_Q)·S_{c-1} + state_c
    """
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    q = min(chunk, s)
    s_orig = s
    if s % q:
        # pad with identity steps: a = 1 (no decay), x = 0 (no state
        # change); the final state is unaffected, padded outputs are cut
        pad = q - s % q
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s += pad
    c = s // q
    tel = get_telemetry()
    with maybe_span(tel, "ssd.chunked", chunks=c, q=q):
        hst = torch.zeros((b, h, p, n), dtype=torch.float32,
                          device=xdt.device) if h0 is None else h0.float()

        xc = xdt.reshape(b, c, q, h, p).float()
        ac = a.reshape(b, c, q, h).float()
        Bc = B.reshape(b, c, q, n).float()
        Cc = C.reshape(b, c, q, n).float()

        la = torch.log(torch.clamp_min(ac, 1e-30))
        cum = torch.cumsum(la, dim=2)                   # (b,c,q,h) inclusive
        total = cum[:, :, -1]                           # (b,c,h)

        with maybe_span(tel, "ssd.intra"):
            intra = (_intra_einsum if train else kops.ssd_intra)(
                xc, cum, Bc, Cc)

        # chunk outflow states, as two two-operand products: x is scaled by
        # the decay first (a three-operand torch.einsum contracts left to
        # right and would build a (b,c,q,n,h,p) intermediate)
        with maybe_span(tel, "ssd.outflow"):
            decay_out = torch.exp(total[:, :, None, :] - cum)   # (b,c,q,h)
            state_c = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                                   xc * decay_out[..., None])

        # cross-chunk recurrence: the state entering each chunk
        with maybe_span(tel, "ssd.chunk_loop"):
            hprevs = xc.new_empty((b, c, h, p, n))
            chunk_decay = torch.exp(total)              # (b,c,h)
            for k in range(c):
                hprevs[:, k] = hst
                hst = hst * chunk_decay[:, k, :, None, None] + state_c[:, k]

        # inflow from earlier chunks, again as two steps
        with maybe_span(tel, "ssd.inflow"):
            inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, hprevs) \
                * torch.exp(cum)[..., None]
            y = (intra + inter).reshape(b, s, h, p)[:, :s_orig]
    return y, hst


# ---------------------------------------------------------------------------
# block ops
# ---------------------------------------------------------------------------

def _conv1d_causal(xBC: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. xBC: (b,s,ch); w: (k,ch). Returns (out,
    new_state (b,k-1,ch)): the last k-1 raw inputs, before bias and silu,
    copied out so the state does not keep the padded sequence alive."""
    k = w.shape[0]
    if state is None:
        state = xBC.new_zeros((xBC.shape[0], k - 1, xBC.shape[-1]))
    padded = torch.cat([state, xBC], dim=1)
    s = xBC.shape[1]
    out = sum(padded[:, i:i + s] * w[i] for i in range(k))
    new_state = padded[:, -(k - 1):].clone() if k > 1 else state
    return out + bias, new_state


def _split_proj(p: Params, x: torch.Tensor, cfg: ModelConfig,
                sh: Sharding = NO_MESH):
    """z, x (the rank's channels), B, C (whole) and dt (the rank's
    heads)."""
    if sh.tp > 1:
        x = sh.enter(x)
        wB, wC = sh.enter(p["wB"]), sh.enter(p["wC"])
    else:
        wB, wC = p["wB"], p["wC"]
    z = x @ p["wz"]
    xs = x @ p["wx"]
    B = x @ wB
    C = x @ wC
    # softplus in float32 with the float32 dt_bias, as the reference
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])
    return z, xs, B, C, dt


def _conv_silu_split(p: Params, xs, B, C, cfg: ModelConfig, conv_state,
                     sh: Sharding = NO_MESH):
    din, n = xs.shape[-1], cfg.ssm_state
    w, bias = p["conv_w"], p["conv_b"]
    if sh.tp > 1:                   # the rank's x columns, the whole B, C
        lo = sh.rank * din
        w, bias = sh.enter(w), sh.enter(bias)
        w = torch.cat([w[:, lo:lo + din], w[:, cfg.d_inner:]], dim=1)
        bias = torch.cat([bias[lo:lo + din], bias[cfg.d_inner:]])
    xBC = torch.cat([xs, B, C], dim=-1)
    xBC, conv_state = _conv1d_causal(xBC, w, bias, conv_state)
    xBC = F.silu(xBC)
    return (xBC[..., :din], xBC[..., din:din + n], xBC[..., din + n:],
            conv_state)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, p: Params,
                cfg: ModelConfig, sh: Sharding) -> torch.Tensor:
    """RMSNorm of ``y · silu(z)`` over all of ``d_inner``: on a mesh the
    rank's channels' sum of squares summed over the model axis."""
    return rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps, sh, cfg.d_inner)


def mamba_seq(p: Params, x: torch.Tensor, cfg: ModelConfig,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None,
              train: bool = False, sh: Sharding = NO_MESH
              ) -> Tuple[torch.Tensor, States]:
    """Full-sequence mamba2 block. x: (B,S,D) -> (y (B,S,D),
    (conv_state, ssm_state)); ``train`` takes the differentiable intra-chunk
    form in place of B5; ``sh`` (``mamba_sharding``'s) the rank's heads."""
    with maybe_span(get_telemetry(), "mamba.seq"):
        b, s, _ = x.shape
        pdim = cfg.ssm_head_dim
        z, xs, B, C, dt = _split_proj(p, x, cfg, sh)
        xs, B, C, conv_state = _conv_silu_split(p, xs, B, C, cfg,
                                                conv_state, sh)
        h = dt.shape[-1]
        xh = xs.reshape(b, s, h, pdim)
        A = -torch.exp(p["A_log"])                      # (h,)
        a = torch.exp(dt * A)                           # (b,s,h)
        xdt = xh * dt[..., None].to(xh.dtype)           # in the model dtype
        y, ssm_state = ssd_chunked(xdt, a, B, C, cfg.ssm_chunk,
                                   h0=ssm_state, train=train)
        y = y + xh.float() * p["D"][:, None]
        y = y.reshape(b, s, h * pdim).to(x.dtype)
        y = _gated_norm(y, z, p, cfg, sh)
        return sh.reduce(y @ p["wo"]), (conv_state, ssm_state)


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor,
                 sh: Sharding = NO_MESH) -> Tuple[torch.Tensor, States]:
    """One-token recurrent step. x: (B,1,D); states as in ``mamba_seq``.
    Returns new states; the ones given are not modified."""
    b = x.shape[0]
    pdim = cfg.ssm_head_dim
    z, xs, B, C, dt = _split_proj(p, x, cfg, sh)
    xs, B, C, conv_state = _conv_silu_split(p, xs, B, C, cfg, conv_state,
                                            sh)
    h = dt.shape[-1]
    xh = xs.reshape(b, h, pdim).float()                 # squeeze s = 1
    dt1 = dt[:, 0]                                      # (b,h)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt1 * A)                              # (b,h)
    with maybe_span(get_telemetry(), "mamba.state"):
        ssm_state = ssm_state * a[..., None, None] \
            + (xh * dt1[..., None])[..., None] \
            * B[:, 0].float()[:, None, None, :]
        y = torch.einsum("bhpn,bn->bhp", ssm_state, C[:, 0].float())
    y = y + xh * p["D"][:, None]
    y = y.reshape(b, 1, h * pdim).to(x.dtype)
    y = _gated_norm(y, z, p, cfg, sh)
    return sh.reduce(y @ p["wo"]), (conv_state, ssm_state)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device, sh: Sharding = NO_MESH) -> States:
    """Zero (conv_state (B, k-1, d_inner + 2N) in the model dtype,
    ssm_state (B, H, P, N) in float32); on a mesh (``sh``,
    ``mamba_sharding``'s) the rank's x channels and heads."""
    din, h = cfg.d_inner // sh.tp, cfg.ssm_heads // sh.tp
    conv = torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * cfg.ssm_state),
                       dtype=dtype, device=device)
    ssm = torch.zeros((batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device)
    return conv, ssm
