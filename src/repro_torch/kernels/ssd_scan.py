"""Intra-chunk SSD quadratic form of Mamba2 (kernel B5): the CUDA kernel's
wrapper and its plain PyTorch version.

For every chunk, row ``i`` and head ``h``::

    out[i] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * xc[j]

The hand-written Hopper kernel (``csrc/ssd_scan.cu``) is the port of the
Pallas kernel ``repro/kernels/ssd_scan.py::_ssd_kernel``. It computes each
chunk's scores ``C . B^T`` once for a group of heads and only at or below
the diagonal, where the TPU grid recomputes the whole square for every head,
and runs both products on the tensor cores in 3xTF32 (each float32 operand
split into TF32 hi and lo parts, three products per pair), which keeps the
float32 tolerance; ``tests/test_torch_ssd.py`` emulates its rounding on the
CPU.
``ssd_intra_plain`` is the same function in plain PyTorch, after
``repro/kernels/ref.py::ssd_intra_ref``: a lower-triangular ``where`` (never
a multiplication by a mask: above the diagonal ``exp`` may be inf), then
two contractions. The CPU path, the checks on the card and the models'
training route (which differentiates it) use it.

Both take the reference's folded layout, all float32: ``xc (BC, Q, H, P)``,
``cum (BC, Q, H)`` (the inclusive cumsum of the log-decay within each
chunk), ``Bc, Cc (BC, Q, N)``, and return ``(BC, Q, H, P)``. The kernel
reads its operands through their strides, so ``Bc`` and ``Cc`` may be
column slices of a wider tensor; it takes ``Q <= 256`` and ``P``, ``N``
multiples of 4 up to 128.

``ssd_intra_folded`` picks by the tensors' device: plain on the CPU, the
kernel on CUDA, where it raises on anything the kernel does not take, and
on ``meta`` the kernel's checks and its output without a launch. Its
``launches`` attribute counts kernel launches. ``cost`` is the kernel's
analytic work: the causal band's float32 operations, the 3xTF32 route's
tensor-core operations and the bytes moved. Like the attention kernels
it refuses inputs that require grad while grad mode is on
(``flash_attention.refuse_grad``): ``models.ssm`` trains on the plain
form.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ._trace import kernel_call
from .flash_attention import refuse_grad

__all__ = ["ssd_intra_folded", "ssd_intra_plain", "check_aligned", "cost"]

#: the longest chunk and the widest head_dim / state the kernel takes
MAX_Q, MAX_PN = 256, 128


def _check(xc, cum, Bc, Cc):
    """Shapes and dtypes of the contract, on either route."""
    if xc.dim() != 4:
        raise ValueError(f"xc must be (BC, Q, H, P), got {tuple(xc.shape)}")
    bc, q, h, _ = xc.shape
    if tuple(cum.shape) != (bc, q, h):
        raise ValueError(f"cum has shape {tuple(cum.shape)}, expected "
                         f"{(bc, q, h)} for xc {tuple(xc.shape)}")
    if Bc.dim() != 3 or tuple(Bc.shape[:2]) != (bc, q) \
            or Cc.shape != Bc.shape:
        raise ValueError(f"Bc and Cc must be (BC, Q, N) = ({bc}, {q}, N), "
                         f"got {tuple(Bc.shape)} and {tuple(Cc.shape)}")
    for name, t in (("xc", xc), ("cum", cum), ("Bc", Bc), ("Cc", Cc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the SSD intra-chunk "
                            f"form takes float32")
        if t.device != xc.device:
            raise ValueError(f"{name} is on {t.device}, xc on {xc.device}")


def check_aligned(name: str, t: torch.Tensor) -> None:
    """What the kernel requires of ``xc``, ``Bc`` and ``Cc``: a contiguous
    last axis and 16-byte aligned rows (it loads 16 bytes at a time)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last axis is not contiguous")
    if t.data_ptr() % 16 or any(st % 4 for st, n in zip(t.stride()[:-1],
                                                       t.shape[:-1]) if n > 1):
        raise ValueError(f"{name} is not 16-byte aligned: pointer "
                         f"{t.data_ptr()}, strides {t.stride()}")


def ssd_intra_plain(xc: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the decay matrix
    ``exp(cum_i - cum_j)`` kept where ``j <= i`` and 0 above, the scores
    ``C_i . B_j``, their product, then the sum over ``j``. Two two-operand
    contractions (a three-operand ``torch.einsum`` contracts left to right
    and may build a far larger intermediate)."""
    _check(xc, cum, Bc, Cc)
    q = xc.shape[1]
    li = cum[:, :, None, :]                               # (bc, i, 1, h)
    lj = cum[:, None, :, :]                               # (bc, 1, j, h)
    mask = torch.ones((q, q), dtype=torch.bool, device=xc.device).tril()
    mask = mask[None, :, :, None]
    # the exponent is masked as well: where exp overflows above the
    # diagonal, its backward would multiply inf by the zero gradient there
    # (NaN, as the reference's einsum form gives); the values are the same
    decay = torch.where(mask, torch.exp(torch.where(mask, li - lj, 0.0)),
                        0.0)
    scores = torch.einsum("bin,bjn->bij", Cc, Bc)
    return torch.einsum("bijh,bjhp->bihp", scores[..., None] * decay, xc)


def cost(xc: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
         Cc: torch.Tensor) -> Dict[str, int]:
    """One call's work over the causal band's ``Q(Q+1)/2`` pairs of each
    chunk: ``flops``, its float32 operations (the scores ``C_i . B_j``
    once a chunk, 2N each; per head a weight, 3 operations, and P
    multiply-adds); ``tf32_flops``, the kernel's route (three TF32
    products, 3xTF32, for each multiply-add of both products); ``bytes``,
    x, cum, B and C read once and the output written once."""
    bc, q, h, p = xc.shape
    n = Bc.shape[-1]
    pairs = q * (q + 1) // 2
    return {"flops": bc * pairs * (2 * n + h * (2 * p + 3)),
            "tf32_flops": 3 * bc * pairs * (2 * n + 2 * h * p),
            "bytes": 4 * bc * q * (2 * h * p + h + 2 * n)}


def ssd_intra_folded(xc: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
                     Cc: torch.Tensor) -> torch.Tensor:
    """The intra-chunk form over the folded layout: the plain version on
    the CPU, the kernel on CUDA (or it raises), its output unwritten on
    ``meta``."""
    refuse_grad("ssd_intra_folded", xc, cum, Bc, Cc)
    _check(xc, cum, Bc, Cc)
    return kernel_call("ssd_scan", _route, cost, xc, cum, Bc, Cc)


def _route(xc, cum, Bc, Cc):
    if xc.device.type == "cpu":          # in the kernel's layout: dense
        return ssd_intra_plain(xc, cum, Bc, Cc).contiguous()
    if xc.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD intra-chunk form for tensors on "
                         f"{xc.device}")
    return _launch(xc, cum, Bc, Cc)


ssd_intra_folded.launches = 0


def _launch(xc, cum, Bc, Cc):
    bc, q, h, p = xc.shape
    n = Bc.shape[-1]
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"chunk length {q} is outside 1..{MAX_Q}")
    for name, size in (("head_dim P", p), ("state N", n)):
        if size % 4 or not 4 <= size <= MAX_PN:
            raise ValueError(f"{name} {size} must be a multiple of 4 in "
                             f"4..{MAX_PN}")
    if bc > 65535:
        raise ValueError(f"grid too large: {bc} chunks")
    for name, t in (("xc", xc), ("Bc", Bc), ("Cc", Cc)):
        check_aligned(name, t)
    out = torch.empty((bc, q, h, p), dtype=torch.float32, device=xc.device)
    if xc.device.type == "meta":         # the dry run: shapes, no launch
        return out
    st = (ctypes.c_longlong * 10)(*xc.stride()[:3], *cum.stride(),
                                  *Bc.stride()[:2], *Cc.stride()[:2])
    lib = _lib()
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    ssd_intra_folded.launches += 1
    err = lib.ssd_scan_launch(xc.data_ptr(), cum.data_ptr(), Bc.data_ptr(),
                              Cc.data_ptr(), out.data_ptr(), st, bc, q, h, p,
                              n, stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load("ssd_scan")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = (
            [vp] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 5 + [vp])
        lib.ssd_scan_launch.restype = ci
        lib.ssd_scan_error_string.argtypes = [ci]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
