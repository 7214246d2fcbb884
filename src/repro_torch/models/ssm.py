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
the tests. The reference's sharding specs (``mamba_pspec``,
``ssm_state_pspec``) have no counterpart.

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
from ..kernels import ops as kops
from ..kernels.ssd_scan import ssd_intra_plain
from .layers import dense_init, he_init, rms_norm

__all__ = ["mamba_init", "mamba_seq", "mamba_decode", "init_ssm_state",
           "ssd_chunked", "ssd_sequential"]

Params = Dict[str, torch.Tensor]
States = Tuple[torch.Tensor, torch.Tensor]


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype
               ) -> Params:
    """He-normal projections and conv from ``gen`` (on its device); zero
    conv bias and norm scale; ``A = -exp(A_log) = -1``, ``D = 1`` and
    ``dt_bias = -2`` (softplus ~0.13), as the reference initialises them."""
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n
    dev = gen.device
    f32 = torch.float32
    return {
        "wz": dense_init(gen, d, din, dtype),
        "wx": dense_init(gen, d, din, dtype),
        "wB": dense_init(gen, d, n, dtype),
        "wC": dense_init(gen, d, n, dtype),
        "wdt": dense_init(gen, d, h, dtype),
        "conv_w": he_init(gen, (cfg.ssm_conv, conv_ch), cfg.ssm_conv, dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=dev),
        "A_log": torch.zeros(h, dtype=f32, device=dev),
        "D": torch.ones(h, dtype=f32, device=dev),
        "dt_bias": torch.full((h,), -2.0, dtype=f32, device=dev),
        "norm": torch.zeros(din, dtype=dtype, device=dev),
        "wo": dense_init(gen, din, d, dtype),
    }


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
    hst = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device) \
        if h0 is None else h0.float()

    xc = xdt.reshape(b, c, q, h, p).float()
    ac = a.reshape(b, c, q, h).float()
    Bc = B.reshape(b, c, q, n).float()
    Cc = C.reshape(b, c, q, n).float()

    la = torch.log(torch.clamp_min(ac, 1e-30))
    cum = torch.cumsum(la, dim=2)                       # (b,c,q,h) inclusive
    total = cum[:, :, -1]                               # (b,c,h)

    intra = (_intra_einsum if train else kops.ssd_intra)(xc, cum, Bc, Cc)

    # chunk outflow states, as two two-operand products: x is scaled by the
    # decay first (a three-operand torch.einsum contracts left to right and
    # would build a (b,c,q,n,h,p) intermediate)
    decay_out = torch.exp(total[:, :, None, :] - cum)   # (b,c,q,h)
    state_c = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                           xc * decay_out[..., None])

    # cross-chunk recurrence: the state entering each chunk
    hprevs = xc.new_empty((b, c, h, p, n))
    chunk_decay = torch.exp(total)                      # (b,c,h)
    for k in range(c):
        hprevs[:, k] = hst
        hst = hst * chunk_decay[:, k, :, None, None] + state_c[:, k]

    # inflow from earlier chunks, again as two steps
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


def _split_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    z = x @ p["wz"]
    xs = x @ p["wx"]
    B = x @ p["wB"]
    C = x @ p["wC"]
    # softplus in float32 with the float32 dt_bias, as the reference
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])
    return z, xs, B, C, dt


def _conv_silu_split(p: Params, xs, B, C, cfg: ModelConfig, conv_state):
    xBC = torch.cat([xs, B, C], dim=-1)
    xBC, conv_state = _conv1d_causal(xBC, p["conv_w"], p["conv_b"],
                                     conv_state)
    xBC = F.silu(xBC)
    din, n = cfg.d_inner, cfg.ssm_state
    return (xBC[..., :din], xBC[..., din:din + n], xBC[..., din + n:],
            conv_state)


def mamba_seq(p: Params, x: torch.Tensor, cfg: ModelConfig,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None,
              train: bool = False) -> Tuple[torch.Tensor, States]:
    """Full-sequence mamba2 block. x: (B,S,D) -> (y (B,S,D),
    (conv_state, ssm_state)); ``train`` takes the differentiable intra-chunk
    form in place of B5."""
    b, s, _ = x.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, B, C, dt = _split_proj(p, x, cfg)
    xs, B, C, conv_state = _conv_silu_split(p, xs, B, C, cfg, conv_state)
    xh = xs.reshape(b, s, h, pdim)
    A = -torch.exp(p["A_log"])                          # (h,)
    a = torch.exp(dt * A)                               # (b,s,h)
    xdt = xh * dt[..., None].to(xh.dtype)               # in the model dtype
    y, ssm_state = ssd_chunked(xdt, a, B, C, cfg.ssm_chunk, h0=ssm_state,
                               train=train)
    y = y + xh.float() * p["D"][:, None]
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["wo"], (conv_state, ssm_state)


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, States]:
    """One-token recurrent step. x: (B,1,D); states as in ``mamba_seq``.
    Returns new states; the ones given are not modified."""
    b = x.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, B, C, dt = _split_proj(p, x, cfg)
    xs, B, C, conv_state = _conv_silu_split(p, xs, B, C, cfg, conv_state)
    xh = xs.reshape(b, h, pdim).float()                 # squeeze s = 1
    dt1 = dt[:, 0]                                      # (b,h)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt1 * A)                              # (b,h)
    ssm_state = ssm_state * a[..., None, None] \
        + (xh * dt1[..., None])[..., None] * B[:, 0].float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", ssm_state, C[:, 0].float())
    y = y + xh * p["D"][:, None]
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["wo"], (conv_state, ssm_state)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> States:
    """Zero (conv_state (B, k-1, d_inner + 2N) in the model dtype,
    ssm_state (B, H, P, N) in float32)."""
    conv = torch.zeros((batch, cfg.ssm_conv - 1,
                        cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                       device=device)
    ssm = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state), dtype=torch.float32, device=device)
    return conv, ssm
