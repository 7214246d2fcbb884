"""One-token flash decode over a KV cache (kernel B4): the CUDA kernel's
wrapper and its plain PyTorch version.

The hand-written Hopper kernel (``csrc/decode_attention.cu``) is the port
of the Pallas kernel ``repro/kernels/decode_attention.py::_decode_kernel``:
every query head of a kv head attends over the cache slots
``[0, valid_len)``, with fp32 running max, sum and accumulator; slots at or
past ``valid_len`` are neither read nor counted. It cuts the live work,
(batch, kv head, head group) rows of tiles of ``valid_len`` slots, into
one contiguous range of tiles for each block of a grid of the device's SMs
times the blocks that fit one (``work_split``, ``default_grid``;
``blocks=`` overrides the grid), streams each block's tiles by TMA through a ring of shared memory
into four consumer warps (tensor cores in bfloat16, CUDA cores in
float32), and merges the shares of a row that several blocks hold in a
second CUDA launch, through a float32 workspace that the wrapper keeps per
device and stream (``_workspace``).
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
           "geometry", "group_size", "work_split", "default_grid",
           "library_geometry", "cost"]

#: the kernel's consumer warps a block (``kConsumerWarps``)
CONSUMER_WARPS = 4
#: bytes of K (or of V) a float32 tile aims at (``kTileBytes``)
TILE_BYTES = 8192
#: blocks a launch at most (``kMaxGrid``)
MAX_GRID = 1 << 15
#: the share of the device's block slots a grid of whole rows may leave
#: empty to save the merge launch (zamba2-7b's 256 rows on the H100's 264
#: slots)
WHOLE_ROWS_SLACK = 0.05


def group_size(G: int) -> int:
    """Query heads a block serves at once: 1, 2, 4 or 8; more than 8 heads
    of a kv head go in groups of 8, each its own row of the work."""
    return 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8


def geometry(hd: int, dtype: torch.dtype):
    """``(slots a tile, slots a warp step)`` of the kernel at head_dim ``hd``
    and ``dtype`` (``Geo<T, HD>::TS``, ``SPW``); slot ``j`` of a tile is
    consumer warp ``(j // step) % CONSUMER_WARPS``'s. bfloat16 runs on the
    tensor cores: tiles of 16 slots a warp. float32 runs on the CUDA cores:
    a slot's row is read by the power of two of lanes that covers its
    16-byte chunks (32 at most), a warp reads ``32 / lanes`` rows a step,
    and a tile is the power of two of rows nearest below ``TILE_BYTES`` of
    K (256 at most)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {dtype}; the kernel takes float32 or "
                        f"bfloat16")
    if dtype == torch.bfloat16:
        return 16 * CONSUMER_WARPS, 16
    row = 4 * hd
    lanes = min(32, 1 << (row // 16 - 1).bit_length())
    return min(256, 1 << (TILE_BYTES // row).bit_length() - 1), 32 // lanes


def work_split(rows: int, tiles: int, blocks: int):
    """Block i's tiles ``[i N // n, (i + 1) N // n)`` of the ``N = rows *
    tiles`` tiles in row-major order (tile ``x`` is tile ``x % tiles`` of
    row ``x // tiles``), for ``n = min(blocks, N)`` blocks: every block has
    one tile or more, and two blocks' counts differ by one at most."""
    if blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    n_all = rows * tiles
    n = min(blocks, n_all)
    return [(i * n_all // n, (i + 1) * n_all // n) for i in range(n)]


def default_grid(rows: int, tiles: int, slots: int) -> int:
    """The grid for ``rows`` rows of ``tiles`` tiles on a device with
    ``slots`` resident blocks (its SMs times the blocks that fit one):
    ``slots`` blocks of ``work_split``'s equal ranges, unless blocks of
    whole rows (``rows / n`` rows each, for ``n`` dividing ``rows``) fill
    all but ``WHOLE_ROWS_SLACK`` of the slots; then the largest such
    ``n``, and no row is shared (no merge). Never more blocks than
    tiles."""
    k = -(-rows // slots)
    while rows // k >= (1 - WHOLE_ROWS_SLACK) * slots:
        if rows % k == 0:
            return rows // k
        k += 1
    return min(slots, rows * tiles, MAX_GRID)


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
         blocks: Optional[int] = None, return_lse: bool = False
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
                            blocks: Optional[int] = None,
                            return_lse: bool = False):
    """Decode attention over the folded (or row-split) layout: the plain
    version on the CPU, the kernel on CUDA (or it raises), its outputs
    unwritten on ``meta``. ``blocks`` overrides the kernel's grid
    (``default_grid`` of the device's SMs times the blocks that fit one;
    at most one block a tile, and ``MAX_GRID``);
    ``return_lse`` returns ``(out, lse)``."""
    refuse_grad("decode_attention_folded", q, k, v)
    return kernel_call("decode_attention", _route, cost, q, k, v,
                       valid_len, blocks=blocks, return_lse=return_lse)


def _route(q, k, v, valid_len, *, blocks, return_lse):
    if q.device.type == "cpu":           # in the kernel's layout: q's
        out = decode_attention_plain(q, k, v, valid_len, return_lse)
        if not return_lse:
            return torch.empty_like(q).copy_(out)
        return torch.empty_like(q).copy_(out[0]), out[1]
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no decode attention for tensors on {q.device}")
    return _launch(q, k, v, valid_len, blocks, return_lse)


decode_attention_folded.launches = 0


def _launch(q, k, v, valid_len, blocks, return_lse=False):
    q4, k4, v4 = _split(q, k, v)
    B, K, G, hd = q4.shape
    n = _valid(valid_len, k4.shape[2])
    ts = geometry(hd, q.dtype)[0]
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    # every stride of k and v is a multiple of 16 bytes, as TMA needs
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        check_operand(name, t, q4)
    o = torch.empty_like(q4)
    check_operand("o", o, q4)
    lse = torch.empty((B, K, G), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.device.type == "meta":          # the dry run: shapes, no launch
        return _outputs(q, o, lse)
    gc = group_size(G)
    rows, per_row = B * K * -(-G // gc), -(-n // ts)
    if blocks is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        grid = default_grid(rows, per_row,
                            sms * _blocks_per_sm(hd, q.dtype, G))
    else:
        grid = min(blocks, rows * per_row, MAX_GRID)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = _workspace(q.device, stream, 2 * grid * gc * (hd + 2))
    st = (ctypes.c_longlong * 12)(*q4.stride()[:3], *k4.stride()[:3],
                                  *v4.stride()[:3], *o.stride()[:3])
    lib = _lib()
    decode_attention_folded.launches += 1
    err = lib.decode_attention_launch(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), ws.data_ptr(), st, B, K,
        G, hd, n, grid, hd ** -0.5, DTYPE_CODES[q.dtype], stream)
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


_PER_SM: Dict[tuple, int] = {}
_WS: Dict[tuple, torch.Tensor] = {}


def _blocks_per_sm(hd: int, dtype: torch.dtype, G: int) -> int:
    """Blocks of the kernel's instance for (hd, dtype, G) that fit one SM,
    from the library's occupancy query."""
    key = (hd, dtype, group_size(G))
    if key not in _PER_SM:
        n = _lib().decode_attention_blocks_per_sm(hd, DTYPE_CODES[dtype], G)
        if n < 1:
            raise RuntimeError(f"decode_attention occupancy query failed "
                               f"({n}) at head_dim {hd}, {dtype}, G {G}")
        _PER_SM[key] = n
    return _PER_SM[key]


def _workspace(device, stream: int, floats: int) -> torch.Tensor:
    """The float32 workspace of a launch on ``stream`` of ``device`` (the
    shares of rows that several blocks hold), allocated once and grown as
    needed: launches on one stream run in order."""
    key = (device.index, stream)
    ws = _WS.get(key)
    if ws is None or ws.numel() < floats:
        ws = _WS[key] = torch.empty(floats, dtype=torch.float32,
                                    device=device)
    return ws


def library_geometry(hd: int, dtype: torch.dtype):
    """``geometry`` as the built library gives it (card only)."""
    out = (ctypes.c_int * 3)()
    if not _lib().decode_attention_geometry(hd, DTYPE_CODES[dtype], out):
        return None
    return out[0], out[1], out[2]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load("decode_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = (
            [vp] * 6 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 6
            + [ctypes.c_float, ci, vp])
        lib.decode_attention_launch.restype = ci
        lib.decode_attention_error_string.argtypes = [ci]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib.decode_attention_geometry.argtypes = [ci, ci,
                                                  ctypes.POINTER(ci)]
        lib.decode_attention_geometry.restype = ci
        lib.decode_attention_blocks_per_sm.argtypes = [ci, ci, ci]
        lib.decode_attention_blocks_per_sm.restype = ci
        _LIB = lib
    return _LIB
