"""Causal / sliding-window GQA flash prefill attention (kernel B3): the
CUDA kernel's wrapper and its plain PyTorch version.

The hand-written Hopper kernel (``csrc/flash_attention.cu``) is the port
of the Pallas kernel ``repro/kernels/flash_attention.py::_flash_kernel``:
an online softmax with fp32 running max, sum and accumulator over the kv
tiles that meet each query tile's causal / window band. It has three
routes behind one entry point, which ``route`` picks from the dtype and
head_dim: bfloat16 at head_dim 64, 112, 128 and 256 (every served
prefill) on the tensor cores through ``wgmma``, with TMA loads and
warp-specialised warpgroups; bfloat16 at head_dim 16 (the reduced test
configs) through ``mma.sync``; both with fp32 accumulators and the
weights entering P·V as two bf16 parts so they keep fp32 precision,
checked at 2e-2; float32 on the CUDA cores (scalar fp32 FMAs, no TF32),
checked at 2e-5. ``tile_geometry`` gives
each bf16 route's query and kv tile; ``library_tiles`` reads them from the
built library, and ``chip_smoke.py``'s build phase holds the two equal.
``flash_attention_plain`` is the same function in plain PyTorch, with the
masks and fp32 math of ``repro/kernels/ref.py::flash_attention_ref``; the
CPU path and the checks on the card use it.

Both take the folded layout of the reference, ``q (BK, G, S, hd)`` and
``k, v (BK, S, hd)``, and also the same with the row axis split as
``(B, K)``: ``q (B, K, G, S, hd)``, ``k, v (B, K, S, hd)``. The split form
lets ``kernels.ops.flash_attention`` hand the kernel permuted views of the
model's ``(B, S, K, G, hd)`` tensors, which it reads through their strides
without a copy. The output has q's shape and dtype (float32 or bfloat16).

``flash_attention_folded`` picks by the tensors' device: plain on the CPU,
the kernel on CUDA, where it raises on anything the kernel does not take,
and on ``meta`` the kernel's checks and its output without a launch (the
dry run, ``launch.dryrun``). Its ``launches`` attribute counts kernel
launches. ``cost`` is the kernel's analytic work (FLOPs of the band,
bytes moved): its bound in ``chip_smoke.py`` and its count in
``launch.analysis.trace_step``. The kernel has no
backward (nor has the reference's), so on either device it refuses inputs
that require grad while grad mode is on (``refuse_grad``): training takes
the models' differentiable route instead.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ._trace import kernel_call

__all__ = ["flash_attention_folded", "flash_attention_plain", "NEG_INF",
           "HEAD_DIMS", "ROUTES", "route", "tile_geometry", "library_tiles",
           "refuse_grad",
           "band_pairs", "cost", "issued_flops"]

#: the reference's large-but-finite mask value
NEG_INF = -2.0 ** 30
#: the head_dim values the kernels are built for: the reduced test configs
#: (16), 64, zamba2's shared attention (112), qwen3 and starcoder2 (128),
#: gemma-7b (256)
HEAD_DIMS = (16, 64, 112, 128, 256)
#: the dtypes the kernels take, with the code their C entry points use
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: B3's routes, with the code its C entry point takes: float32 on the CUDA
#: cores, bfloat16 through ``mma.sync`` (head_dim 16) or through ``wgmma``
#: with TMA loads (head_dim 64, 112, 128 and 256)
ROUTES = {"f32": 0, "mma": 1, "wgmma": 2}
#: the head_dims of the ``wgmma`` route
WGMMA_HEAD_DIMS = (64, 112, 128, 256)


def route(hd: int, dtype: torch.dtype) -> str:
    """The kernel route for ``head_dim`` and dtype (a key of ``ROUTES``)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"dtype {dtype}; the kernel takes float32 or "
                        f"bfloat16")
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"


def tile_geometry(hd: int, dtype: torch.dtype) -> Dict[str, int]:
    """The bf16 route's query rows per block (``bq``) and kv rows per tile
    (``bkv``), as the kernel sets them (``library_tiles`` reads them back):
    the kv tiles are where the online softmax rescales, so the CPU
    emulation of the bf16 routes and ``issued_flops`` follow them."""
    r = route(hd, dtype)
    if r == "wgmma":     # at 256, S and P over 80 columns beside O's 128
        return {"bq": 128, "bkv": 80 if hd == 256 else 128}
    if r == "mma":
        return {"bq": 128, "bkv": 64}
    raise ValueError("the float32 route has no tensor-core tiles")


def library_tiles(hd: int, r: str) -> Optional[Dict[str, int]]:
    """The tiles the built kernel library runs bf16 route ``r`` (``"mma"``
    or ``"wgmma"``) with at ``hd``, or None where it does not run that
    route there: what ``route`` and ``tile_geometry`` must agree with."""
    t = (ctypes.c_int * 2)()
    if not _lib().flash_attention_tiles(hd, ROUTES[r], t):
        return None
    return {"bq": t[0], "bkv": t[1]}


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad: a
    kernel's launch is invisible to autograd, so its inputs would get no
    gradient, silently (the CPU's plain version would give one, so this
    holds on both devices)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: autograd records nothing for its "
            f"kernel, so its inputs would get no gradient. Train through "
            f"the models' loss_fn, whose forward(train=True) takes the "
            f"differentiable route, or call it under torch.no_grad()")


def _split(q, k, v):
    """Folded tensors as (B, K, ...) views: a (BK, ...) row axis becomes
    (BK, 1, ...)."""
    if q.dim() == 4 and k.dim() == 3 and v.dim() == 3:
        return q[:, None], k[:, None], v[:, None]
    if q.dim() == 5 and k.dim() == 4 and v.dim() == 4:
        return q, k, v
    raise ValueError(f"q must be (BK, G, S, hd) with k, v (BK, S, hd), or "
                     f"(B, K, G, S, hd) with k, v (B, K, S, hd); got "
                     f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _check_shapes(q5, k4, v4):
    B, K, G, S, hd = q5.shape
    for name, t in (("k", k4), ("v", v4)):
        if tuple(t.shape) != (B, K, S, hd):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, K, S, hd)} for q {tuple(q5.shape)}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores over the whole
    row, masked to the causal / window band with ``NEG_INF``, softmax, fp32
    P·V; returned in q's dtype."""
    q5, k4, v4 = _split(q, k, v)
    _check_shapes(q5, k4, v4)
    s, hd = q5.shape[-2:]
    scores = torch.einsum("bkgqd,bkcd->bkgqc", q5.float(),
                          k4.float()) * hd ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    w = torch.softmax(torch.where(ok, scores, NEG_INF), dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", w, v4.float()).to(q.dtype)
    return out if q.dim() == 5 else out[:, 0]


def band_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal / window band of ``S``
    positions: key ``j`` of query ``i`` when ``i - window < j`` (a window)
    and ``j <= i`` (causal)."""
    if causal:
        w = min(window, S) if window else S
        return w * (w + 1) // 2 + (S - w) * w
    if window and S > window:
        return S * S - (S - window) * (S - window + 1) // 2
    return S * S


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: int) -> Dict[str, int]:
    """One call's work: ``flops``, the two products (scores and P·V, 2
    FLOPs a multiply-add) over the band's pairs; ``bytes``, q, k and v read
    once and the output written once."""
    q5, k4, v4 = _split(q, k, v)
    B, K, G, S, hd = q5.shape
    return {"flops": 4 * B * K * G * band_pairs(S, causal, window) * hd,
            "bytes": q5.element_size() * (2 * q5.numel() + k4.numel()
                                          + v4.numel())}


def issued_flops(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int) -> int:
    """The tensor-core FLOPs the ``wgmma`` route issues for one call: every
    kv tile (``tile_geometry``'s) that meets a 128-row q tile's band, whole
    (the masks zero what lies outside the band, and both consumer
    warpgroups run every tile), with the scores over head_dim and P·V
    twice, for the hi and the lo part of the weights."""
    q5, k4, v4 = _split(q, k, v)
    B, K, G, S, hd = q5.shape
    if route(hd, q.dtype) != "wgmma":
        raise ValueError(f"head_dim {hd} in {q.dtype} does not take the "
                         f"wgmma route")
    t = tile_geometry(hd, q.dtype)
    bq, bkv = t["bq"], t["bkv"]
    tiles = 0
    for q0 in range(0, S, bq):           # the kernel's kv_range
        hi = min(S, q0 + bq) if causal else S
        lo = max(0, q0 - window + 1) if window else 0
        tiles += -(-hi // bkv) - lo // bkv
    return B * K * G * tiles * bq * bkv * 2 * 3 * hd


def flash_attention_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, window: int) -> torch.Tensor:
    """Prefill attention over the folded (or row-split) layout: the plain
    version on the CPU, the kernel on CUDA (or it raises), its output
    unwritten on ``meta``."""
    refuse_grad("flash_attention_folded", q, k, v)
    return kernel_call("flash_attention", _route, cost, q, k, v,
                       causal=causal, window=window)


def _route(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    if q.device.type == "cpu":           # in the kernel's layout: q's
        return torch.empty_like(q).copy_(flash_attention_plain(
            q, k, v, causal=causal, window=window))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash attention for tensors on {q.device}")
    return _launch(q, k, v, causal=causal, window=window)


flash_attention_folded.launches = 0


def check_operand(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    """What both attention kernels require of an operand: q's device and
    dtype, a contiguous head_dim, and 16-byte aligned rows (the kernels load
    16 bytes at a time)."""
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, q on {ref.device}")
    if t.dtype != ref.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, q {ref.dtype}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s head_dim is not contiguous")
    if t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:-1],
                                                       t.shape[:-1]) if n > 1):
        raise ValueError(f"{name} is not 16-byte aligned: pointer "
                         f"{t.data_ptr()}, strides {t.stride()}")


def _launch(q, k, v, *, causal: bool, window: int):
    q5, k4, v4 = _split(q, k, v)
    _check_shapes(q5, k4, v4)
    B, K, G, S, hd = q5.shape
    code = ROUTES[route(hd, q.dtype)]
    if S < 1 or window < 0:
        raise ValueError(f"need seq >= 1 and window >= 0, got {S}, {window}")
    if B * K > 65535 or G > 65535:
        raise ValueError(f"grid too large: B*K {B * K}, G {G}")
    for name, t in (("q", q5), ("k", k4), ("v", v4)):
        check_operand(name, t, q5)
    o = torch.empty_like(q5)             # q's layout: dense views stay dense
    check_operand("o", o, q5)
    if q.device.type == "meta":          # the dry run: shapes, no launch
        return o if q.dim() == 5 else o[:, 0]
    st = (ctypes.c_longlong * 14)(*q5.stride()[:4], *k4.stride()[:3],
                                  *v4.stride()[:3], *o.stride()[:4])
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attention_folded.launches += 1
    err = lib.flash_attention_launch(
        q5.data_ptr(), k4.data_ptr(), v4.data_ptr(), o.data_ptr(), st, B, K,
        G, S, hd, int(bool(causal)), int(window), hd ** -0.5, code, stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    return o if q.dim() == 5 else o[:, 0]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load("flash_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [vp] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 7
            + [ctypes.c_float, ci, vp])
        lib.flash_attention_launch.restype = ci
        lib.flash_attention_wgmma_smem.argtypes = [ci]
        lib.flash_attention_wgmma_smem.restype = ci
        lib.flash_attention_tiles.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.flash_attention_tiles.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
