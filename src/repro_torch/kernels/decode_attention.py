"""One-token flash decode over a KV cache (kernel B4): the CUDA kernel's
wrapper and its plain PyTorch version.

The hand-written Hopper kernel (``csrc/decode_attention.cu``) is the port
of the Pallas kernel ``repro/kernels/decode_attention.py::_decode_kernel``:
every query head of a kv head attends over the cache slots
``[0, valid_len)``, with fp32 running max, sum and accumulator; slots at or
past ``valid_len`` are neither read nor counted. It splits each
(batch, kv head) row's live slots over a cluster of up to 8 blocks
(``decode_split`` picks how many, and how many slots each takes), stages
each block's keys and values through a ring of shared-memory tiles, and
combines the blocks' partial softmax states on chip, in the same launch.
``decode_attention_plain`` is the same function in plain PyTorch, after
``repro/kernels/ref.py::decode_attention_ref``.

Both take the folded layout of the reference, ``q (BK, G, hd)`` and
``k, v (BK, C, hd)``, and also the same with the row axis split as
``(B, K)``: ``q (B, K, G, hd)``, ``k, v (B, K, C, hd)``. The split form lets
``kernels.ops.decode_attention`` hand the kernel a permuted view of the
model's ``(B, C, K, hd)`` cache, which it reads in place through its
strides. ``valid_len`` is one Python int (or 0-d tensor) for the whole
batch, 1 <= valid_len <= C. The output has q's shape and dtype; with
``return_lse=True`` it comes with each head's float32 log-sum-exp of its
scaled scores over the live slots, q's shape without ``hd``, which
sequence-parallel decode needs to merge the outputs of slices of one
cache (``models.attention``).

``decode_attention_folded`` picks by the tensors' device: plain on the
CPU, the kernel on CUDA, where it raises on anything the kernel does not
take, and on ``meta`` the kernel's checks and its outputs without a
launch. Its ``launches`` attribute counts kernel launches (one per call).
``cost`` is the kernel's analytic work (``flash_attention.cost``'s
counterpart over the live slots).
It refuses inputs that require grad while grad mode is on
(``flash_attention.refuse_grad``): the kernel has no backward.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ._trace import kernel_call
from .flash_attention import (DTYPE_CODES, HEAD_DIMS, NEG_INF,
                              check_operand, refuse_grad)

__all__ = ["decode_attention_folded", "decode_attention_plain",
           "decode_split", "cost"]

#: blocks per (batch, kv head) row at most: the portable cluster size
MAX_SPLIT = 8
#: blocks a launch aims at: one and a half for each of the H100's 132 SMs
#: (blocks of 8 warps, two fit an SM). Measured on an H100 over 1 to 8
#: splits (``chip_smoke.py``'s time-attn): fewer, longer blocks beat more
#: waves of short ones, 3 splits at qwen3-0.6b's 64 rows and 1 at
#: zamba2-7b's 256
TARGET_BLOCKS = 3 * 132 // 2
#: query heads a block serves at most (more go to further blocks)
MAX_GROUP = 4
#: slots a block's range is a multiple of: a multiple of every shared-memory
#: tile the kernel stages (64, 32 or 16 slots, by head_dim and dtype)
GRANULE = 64


def _split(q, k, v):
    """Folded tensors as (B, K, ...) views: a (BK, ...) row axis becomes
    (BK, 1, ...)."""
    if q.dim() == 3 and k.dim() == 3 and v.dim() == 3:
        q, k, v = q[:, None], k[:, None], v[:, None]
    elif not (q.dim() == 4 and k.dim() == 4 and v.dim() == 4):
        raise ValueError(f"q must be (BK, G, hd) with k, v (BK, C, hd), or "
                         f"(B, K, G, hd) with k, v (B, K, C, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, K, G, hd = q.shape
    C = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, K, C, hd):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, K, C, hd)} for q {tuple(q.shape)}")
    return q, k, v


def _valid(valid_len, C: int) -> int:
    n = int(valid_len)
    if not 1 <= n <= C:
        raise ValueError(f"valid_len must be in [1, {C}], got {n}")
    return n


def decode_split(rows: int, valid: int, splits: Optional[int] = None):
    """``(splits, chunk)`` for ``rows`` (batch, kv head, head group) rows of
    ``valid`` live slots: block r of a row's ``splits`` takes slots
    ``[r * chunk, min((r + 1) * chunk, valid))``, a whole number of
    ``GRANULE``-slot granules. ``splits`` (unless given) keeps the grid
    within ``TARGET_BLOCKS``, at most ``MAX_SPLIT`` and no more than the
    row's granules; a block may still be empty (``r * chunk >= valid``)."""
    n = -(-valid // GRANULE)
    if splits is None:
        splits = max(1, min(MAX_SPLIT, n, TARGET_BLOCKS // rows))
    if not 1 <= splits <= MAX_SPLIT:
        raise ValueError(f"splits must be in [1, {MAX_SPLIT}], got {splits}")
    return splits, -(-n // splits) * GRANULE


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len, return_lse: bool = False):
    """The kernel's function in plain PyTorch: fp32 scores over every
    slot, slots >= ``valid_len`` masked with ``NEG_INF``, softmax, fp32
    P·V; returned in q's dtype (with ``return_lse``, and the scores'
    ``torch.logsumexp``)."""
    q4, k4, v4 = _split(q, k, v)
    C, hd = k4.shape[2:]
    n = _valid(valid_len, C)
    s = torch.einsum("bkgd,bkcd->bkgc", q4.float(), k4.float()) * hd ** -0.5
    live = torch.arange(C, device=q.device) < n
    s = torch.where(live, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bkcd->bkgd", w, v4.float()).to(q.dtype)
    out = out if q.dim() == 4 else out[:, 0]
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    return out, (lse if q.dim() == 4 else lse[:, 0])


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len, *,
         splits: Optional[int] = None, return_lse: bool = False
         ) -> Dict[str, int]:
    """One call's work: ``flops``, the two products over the ``valid_len``
    live slots (2 FLOPs a multiply-add); ``bytes``, the live slots' keys
    and values and q read once, the output (and the float32 lse) written
    once."""
    q4, k4, _ = _split(q, k, v)
    B, K, G, hd = q4.shape
    n = _valid(valid_len, k4.shape[2])
    nbytes = q4.element_size() * (2 * B * K * n * hd + 2 * q4.numel())
    return {"flops": 4 * B * K * G * n * hd,
            "bytes": nbytes + (4 * B * K * G if return_lse else 0)}


def decode_attention_folded(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid_len, *,
                            splits: Optional[int] = None,
                            return_lse: bool = False):
    """Decode attention over the folded (or row-split) layout: the plain
    version on the CPU, the kernel on CUDA (or it raises), its outputs
    unwritten on ``meta``. ``splits`` overrides the kernel's blocks per
    row (``decode_split``); ``return_lse`` returns ``(out, lse)``."""
    refuse_grad("decode_attention_folded", q, k, v)
    return kernel_call("decode_attention", _route, cost, q, k, v,
                       valid_len, splits=splits, return_lse=return_lse)


def _route(q, k, v, valid_len, *, splits, return_lse):
    if q.device.type == "cpu":           # in the kernel's layout: q's
        out = decode_attention_plain(q, k, v, valid_len, return_lse)
        if not return_lse:
            return torch.empty_like(q).copy_(out)
        return torch.empty_like(q).copy_(out[0]), out[1]
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no decode attention for tensors on {q.device}")
    return _launch(q, k, v, valid_len, splits, return_lse)


decode_attention_folded.launches = 0


def _launch(q, k, v, valid_len, splits, return_lse=False):
    q4, k4, v4 = _split(q, k, v)
    B, K, G, hd = q4.shape
    n = _valid(valid_len, k4.shape[2])
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if B * K > 65535:
        raise ValueError(f"grid too large: B*K {B * K}")
    groups = -(-G // (G if G <= 2 else MAX_GROUP))  # the kernel's head groups
    splits, chunk = decode_split(B * K * groups, n, splits)
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        check_operand(name, t, q4)
    o = torch.empty_like(q4)
    check_operand("o", o, q4)
    lse = torch.empty((B, K, G), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.device.type == "meta":          # the dry run: shapes, no launch
        return _outputs(q, o, lse)
    st = (ctypes.c_longlong * 12)(*q4.stride()[:3], *k4.stride()[:3],
                                  *v4.stride()[:3], *o.stride()[:3])
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    decode_attention_folded.launches += 1
    err = lib.decode_attention_launch(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), st, B, K, G, hd, n, splits,
        chunk, hd ** -0.5, DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            "decode_attention kernel launch failed: "
            f"{lib.decode_attention_error_string(err).decode()}")
    return _outputs(q, o, lse)


def _outputs(q, o, lse):
    """The caller's layout of the kernel's ``o`` (and ``lse``)."""
    out = o if q.dim() == 4 else o[:, 0]
    if lse is None:
        return out
    return out, (lse if q.dim() == 4 else lse[:, 0])


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load("decode_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = (
            [vp] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 7
            + [ctypes.c_float, ci, vp])
        lib.decode_attention_launch.restype = ci
        lib.decode_attention_error_string.argtypes = [ci]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
