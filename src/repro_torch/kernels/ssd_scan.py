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
CPU. Two routes, picked on the host from the shape by ``route``: ``wgmma``
(``P`` 64, ``N`` 64 or 128, every served model: a persistent grid over
``work_list``'s items, TMA loads, split tiles, ``wgmma`` with the decay
weights from registers) and ``mma`` (every other width: ``mma.sync``).
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
analytic work: the causal band's float32 operations, its 3xTF32
tensor-core operations, the ``wgmma`` route's issued tensor work over
whole tiles, and the bytes moved. The wgmma route's schedule is fixed
(``head_group``, ``WINDOW``, one block an SM); only measurements and
checks set another, through ``_launch``'s ``schedule``. Like the attention
kernels it refuses inputs that require grad while grad mode is on
(``flash_attention.refuse_grad``): ``models.ssm`` trains on the plain
form.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ._trace import kernel_call
from .flash_attention import refuse_grad

__all__ = ["ssd_intra_folded", "ssd_intra_plain", "check_aligned", "cost",
           "route", "head_group", "work_list"]

#: the longest chunk and the widest head_dim / state the kernel takes
MAX_Q, MAX_PN = 256, 128
#: the kernel's routes, as its C entry numbers them
ROUTES = {"mma": 0, "wgmma": 1}
#: the head_dims and states the wgmma route takes
WGMMA_HEAD_DIMS, WGMMA_STATES = (64,), (64, 128)
#: the wgmma route's rows a work item (one wgmma m64) and most heads a group
ROWS, MAX_HEADS = 64, 16
#: chunks a window of the work list: an item's x tiles are met again by the
#: chunk's other row tiles within the window, while they are in the L2
WINDOW = 8


def route(p: int, n: int) -> str:
    """The kernel's route at head_dim ``p`` and state ``n``."""
    return "wgmma" if p in WGMMA_HEAD_DIMS and n in WGMMA_STATES else "mma"



def head_group(h: int, heads=None) -> int:
    """Heads a work item of the wgmma route takes: ``heads`` if given, else
    the fewest groups of at most ``MAX_HEADS``, as even as they come."""
    if heads is None:
        groups = -(-h // MAX_HEADS)
        heads = -(-h // groups)
    if not 1 <= heads <= MAX_HEADS:
        raise ValueError(f"heads {heads} outside 1..{MAX_HEADS}")
    return heads


def work_list(bc: int, q: int, h: int, heads=None, window=None):
    """The wgmma route's work items ``(chunk, row tile, head group)`` in the
    order its blocks draw them: windows of ``window`` chunks in turn; in
    each, the row tiles from the last (the heaviest: it runs to the
    diagonal over every earlier tile) to the first, each over the window's
    chunks and their head groups."""
    window = WINDOW if window is None else window
    if window < 1:
        raise ValueError(f"window {window} < 1")
    groups = -(-h // head_group(h, heads))
    tiles = -(-q // ROWS)
    return [(c, t, g) for c0 in range(0, bc, window)
            for t in reversed(range(tiles))
            for c in range(c0, min(bc, c0 + window)) for g in range(groups)]


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
    multiply-adds); ``tf32_flops``, three TF32 products (3xTF32) for each
    multiply-add of both products; ``issued_flops``, what the wgmma route
    issues over whole 64 x 64 tiles up to the diagonal, three products
    each: per work item (chunk, row tile t, head group) the scores of its
    t + 1 j tiles over N, once, and each head's t + 1 x tiles; ``bytes``,
    x, cum, B and C read once and the output written once."""
    bc, q, h, p = xc.shape
    n = Bc.shape[-1]
    pairs = q * (q + 1) // 2
    groups = -(-h // head_group(h))
    tiles = -(-q // ROWS)
    tile_pairs = tiles * (tiles + 1) // 2        # j tiles over the row tiles
    return {"flops": bc * pairs * (2 * n + h * (2 * p + 3)),
            "tf32_flops": 3 * bc * pairs * (2 * n + 2 * h * p),
            "issued_flops": 3 * 2 * ROWS * ROWS * bc * tile_pairs
            * (groups * n + h * p),
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


def _launch(xc, cum, Bc, Cc, schedule=None):
    """One launch on ``xc``'s device (on ``meta``, the checks and the
    output alone). ``schedule``, for measurements and checks, overrides
    the kernel's: ``route`` (``"mma"`` takes every shape, ``"wgmma"`` only
    its own), and the wgmma route's ``heads`` a work item, ``window``
    (chunks a window of ``work_list``), ``blocks`` (the persistent grid,
    default the SM count) and ``draw`` (False: block b walks items b, b +
    blocks, .. instead of drawing them from a counter)."""
    schedule = dict(schedule or {})
    use, heads = schedule.pop("route", None), schedule.pop("heads", None)
    window = schedule.pop("window", WINDOW)
    blocks, draw = schedule.pop("blocks", None), schedule.pop("draw", True)
    if schedule:
        raise ValueError(f"unknown schedule keys {sorted(schedule)}")
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
    own = route(p, n)
    r = own if use is None else use
    if r not in ROUTES or (r == "wgmma" and own != "wgmma"):
        raise ValueError(f"route {r!r} does not take P {p}, N {n} (its "
                         f"route is {own!r})")
    heads = head_group(h, heads)
    if window < 1 or (blocks is not None and blocks < 1):
        raise ValueError(f"window {window} and blocks {blocks} must be >= 1")
    out = torch.empty((bc, q, h, p), dtype=torch.float32, device=xc.device)
    if xc.device.type == "meta":         # the dry run: shapes, no launch
        return out
    st = (ctypes.c_longlong * 10)(*xc.stride()[:3], *cum.stride(),
                                  *Bc.stride()[:2], *Cc.stride()[:2])
    lib = _lib()
    cuda_stream = torch.cuda.current_stream(xc.device)
    counter = None                       # the items' counter, 0 at the start
    if r == "wgmma":
        if draw:
            counter = torch.zeros(1, dtype=torch.int32, device=xc.device)
        if blocks is None:
            blocks = torch.cuda.get_device_properties(
                xc.device).multi_processor_count
    ssd_intra_folded.launches += 1
    err = lib.ssd_scan_launch(xc.data_ptr(), cum.data_ptr(), Bc.data_ptr(),
                              Cc.data_ptr(), out.data_ptr(), st, bc, q, h, p,
                              n, ROUTES[r], heads, window, blocks or 0,
                              None if counter is None else counter.data_ptr(),
                              cuda_stream.cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    return out


def library_route(p: int, n: int) -> str:
    """The route the built library runs at ``(p, n)`` (``route`` must give
    the same)."""
    code = _lib().ssd_scan_route(p, n)
    return {v: k for k, v in ROUTES.items()}[code]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load("ssd_scan")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = (
            [vp] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 9
            + [vp, vp])
        lib.ssd_scan_launch.restype = ci
        lib.ssd_scan_error_string.argtypes = [ci]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_route.argtypes = [ci, ci]
        lib.ssd_scan_route.restype = ci
        lib.ssd_scan_wgmma_smem.argtypes = []
        lib.ssd_scan_wgmma_smem.restype = ci
        _LIB = lib
    return _LIB
