"""Plain float32 Mamba2 language model, written from the published equations
(Dao and Gu, arXiv:2405.21060, section 7 and the reference ``Mamba2`` layer),
as the benchmark's configuration file states them. It shares no code with the
served program and takes only the benchmark's own weights and token ids.

Per block, on the pre-normed input h (``RMSNorm(x) * (1 + ln)``)::

    z, x, B, C = h Wz, h Wx, h WB, h WC          dt = softplus(h Wdt + dt_bias)
    x, B, C    = silu(depthwise causal conv1d([x, B, C]) + conv_b)
    y_i        = sum_{j <= i} (C_i . B_j) exp(sum_{j < t <= i} dt_t A) dt_j x_j
                 + D x_i                          A = -exp(A_log), per head
    out        = (RMSNorm(y * silu(z)) * (1 + norm)) Wo;   x <- x + out

The sequence mixing is computed in its dual, quadratic form over the whole
sequence (the semiseparable matrix of the paper's section 3), one row and a
block of heads at a time, not in chunks and not by the recurrence. The head is
the tied embedding. ``embed_scale`` multiplies the embedding lookup (the served
program's convention, stated in the configuration file).

``matmul="fp8"`` rounds both operands of every projection and of the head to
float8 e4m3 (a scale per weight tensor, one per activation row), the next
precision below the served bfloat16: the control of the benchmark's check.

Beside the forward, the configuration's own arithmetic for the metrics:
``flops``, the model FLOPs of a served call from its shapes, and
``ssd_launch_shape``, the shape of each B5 launch of a prefill.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["dims", "logits_at", "flops", "ssd_launch_shape", "FP8_MAX"]

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


def dims(conf: Dict) -> Dict[str, float]:
    """The sizes the forward needs, from the configuration file's keys."""
    m = conf["mamba2"]
    d = conf["d_model"]
    d_inner = m["expand"] * d
    return {"d": d, "layers": conf["n_layer"], "vocab": conf["vocab_size"],
            "d_inner": d_inner, "heads": d_inner // m["headdim"],
            "head_dim": m["headdim"], "state": m["d_state"],
            "conv": m["d_conv"], "eps": conf["norm_epsilon"],
            "embed_scale": math.sqrt(d) if conf["embedding_scale"]
            == "sqrt(d_model)" else 1.0}


def _fp8(t: torch.Tensor, dim) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under an absmax scale over ``dim`` (None:
    the whole tensor), back in float32."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _matmul(kind: str) -> Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor]:
    if kind == "fp32":
        return torch.matmul
    if kind == "fp8":
        return lambda a, w: _fp8(a, -1) @ _fp8(w, None)
    raise ValueError(f"unknown matmul precision {kind!r}")


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _ssd_dual(xdt: torch.Tensor, logdecay: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, head_block: int) -> torch.Tensor:
    """One row. xdt (S,H,P), logdecay (S,H) = dt A, B, C (S,N) -> y (S,H,P):
    the lower-triangular semiseparable matrix applied whole."""
    s, h, p = xdt.shape
    seg = torch.cumsum(logdecay, 0)                     # (S,H)
    scores = C @ B.T                                    # (S,S)
    causal = torch.ones(s, s, dtype=torch.bool, device=xdt.device).tril()
    y = torch.empty_like(xdt)
    for h0 in range(0, h, head_block):
        hs = slice(h0, min(h, h0 + head_block))
        diff = seg[:, None, hs] - seg[None, :, hs]      # (S,S,hb): i, j
        w = torch.where(causal[..., None], diff, -math.inf).exp_()
        w.mul_(scores[..., None])
        y[:, hs] = torch.einsum("ijh,jhp->ihp", w, xdt[:, hs])
    return y


def _block(x: torch.Tensor, w: Dict[str, torch.Tensor], dm: Dict,
           mm, head_block: int) -> torch.Tensor:
    """One residual Mamba2 block over x (R,S,d), float32."""
    r, s, _ = x.shape
    din, n, heads, p = dm["d_inner"], dm["state"], dm["heads"], \
        dm["head_dim"]
    h = _rms(x, w["ln"], dm["eps"])
    z, xs, B, C = (mm(h, w[k]) for k in ("wz", "wx", "wB", "wC"))
    dt = F.softplus(mm(h, w["wdt"]) + w["dt_bias"])     # (R,S,H)
    xbc = torch.cat([xs, B, C], -1).transpose(1, 2)     # (R,ch,S)
    k = w["conv_w"].shape[0]
    conv = F.conv1d(F.pad(xbc, (k - 1, 0)), w["conv_w"].T[:, None],
                    w["conv_b"], groups=xbc.shape[1])
    xbc = F.silu(conv).transpose(1, 2)
    xs, B, C = xbc[..., :din], xbc[..., din:din + n], xbc[..., din + n:]
    xh = xs.reshape(r, s, heads, p)
    A = -torch.exp(w["A_log"])
    y = torch.stack([_ssd_dual(xh[i] * dt[i, ..., None], dt[i] * A, B[i],
                               C[i], head_block) for i in range(r)])
    y = (y + xh * w["D"][:, None]).reshape(r, s, din)
    y = _rms(y * F.silu(z), w["norm"], dm["eps"])
    return x + mm(y, w["wo"])


@torch.no_grad()
def logits_at(conf: Dict, weights: Callable[[str], torch.Tensor],
              tokens: torch.Tensor, positions: Sequence[int],
              matmul: str = "fp32", head_block: int = 16) -> torch.Tensor:
    """Logits (R, len(positions), V) in float32 of the full forward over
    ``tokens`` (R,S) at ``positions``. ``weights(name)`` gives a weight by
    its name (``embed``, ``final_norm``, ``blocks.<i>.ln``,
    ``blocks.<i>.mamba.<w>``), in any dtype; each is used in float32, one
    block at a time."""
    dm = dims(conf)
    mm = _matmul(matmul)

    def f32(name):
        return weights(name).float()

    embed = f32("embed")
    x = embed[tokens.long()] * dm["embed_scale"]
    names = ("wz", "wx", "wB", "wC", "wdt", "dt_bias", "conv_w", "conv_b",
             "A_log", "D", "norm", "wo")
    for i in range(dm["layers"]):
        w = {k: f32(f"blocks.{i}.mamba.{k}") for k in names}
        w["ln"] = f32(f"blocks.{i}.ln")
        x = _block(x, w, dm, mm, head_block)
    x = _rms(x[:, list(positions)], f32("final_norm"), dm["eps"])
    return mm(x, embed.T)


def flops(conf: Dict, batch: int, prompt: int, new: int) -> Dict[str, float]:
    """Model FLOPs of one served call of ``batch`` rows: ``prefill`` (every
    prompt token through every block, the head at the last prompt position)
    and ``decode`` (``new - 1`` fed-back tokens through every block, and the
    head at each). A block is 2 FLOPs a weight of its projections (in: d x
    (2 d_inner + 2N + H); out: d_inner x d) plus the recurrent form of its
    sequence mixing: per head the state update and read-out, 4 P N, and the
    depthwise conv, 2 k (d_inner + 2N). The head is the tied embedding,
    2 d V. Shapes only: what the implementation happens to dispatch does not
    count."""
    dm = dims(conf)
    d, n, p, din, h = (dm["d"], dm["state"], dm["head_dim"], dm["d_inner"],
                       dm["heads"])
    block = 2 * (d * (2 * din + 2 * n + h) + din * d) \
        + 4 * h * p * n + 2 * dm["conv"] * (din + 2 * n)
    token = dm["layers"] * block
    head = 2 * d * dm["vocab"]
    return {"prefill": float(batch * (prompt * token + head)),
            "decode": float(batch * (new - 1) * (token + head))}


def ssd_launch_shape(conf: Dict, batch: int, prompt: int
                     ) -> Tuple[int, int, int, int, int]:
    """(BC, Q, H, P, N) of each B5 launch of a prefill of ``batch`` rows of
    ``prompt`` tokens: chunks of ``min(chunk_size, prompt)``, the sequence
    padded up to a whole number of them."""
    dm = dims(conf)
    q = min(conf["mamba2"]["chunk_size"], prompt)
    return (batch * -(-prompt // q), q, dm["heads"], dm["head_dim"],
            dm["state"])
