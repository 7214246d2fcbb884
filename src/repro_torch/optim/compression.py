"""int8 error-feedback gradient compression: the port of
``repro/optim/compression.py``.

Per-tensor symmetric quantization, ``scale = max|g| / 127``, rounding half
to even (as ``jnp.round``); the quantization error is kept in a float32
residual and added to the next step's gradient, so nothing is dropped for
good. ``compress_error_feedback`` returns the gradients as they would
arrive after an int8 wire, in their own dtype, and the new residual.

On a device mesh the residual is sharded like the parameters, and a
rank's gradient may be a slice of its tensor: the scale is the whole
tensor's, ``max|g|`` taken over the slice's process group (``groups``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.collectives import all_reduce

__all__ = ["CompressionState", "compress_error_feedback", "quantize_int8",
           "dequantize_int8", "init_compression"]


class CompressionState(NamedTuple):
    error: Dict[str, torch.Tensor]      # float32 residual, by name


def quantize_int8(g: torch.Tensor, group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale ()) of ``g`` (a slice of a tensor over
    ``group``: the whole tensor's scale)."""
    g32 = g.float()
    amax = torch.max(torch.abs(g32))
    if group is not None:
        amax = all_reduce(amax, group, dist.ReduceOp.MAX)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_compression(params: Mapping[str, torch.Tensor]) -> CompressionState:
    return CompressionState(error={
        n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in params.items()})


@torch.no_grad()
def compress_error_feedback(grads: Mapping[str, torch.Tensor],
                            state: CompressionState,
                            groups: Optional[Mapping[str, Any]] = None
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       CompressionState]:
    """(decompressed grads, new residual state): each gradient plus its
    residual is quantized to int8 and back; what rounding lost is the next
    residual. ``groups``: a sliced tensor's process group (its scale is
    the whole tensor's), as ``adamw.global_norm``."""
    out, error = {}, {}
    groups = groups or {}
    for name, g in grads.items():
        corrected = g.float() + state.error[name]
        deq = dequantize_int8(*quantize_int8(corrected, groups.get(name)))
        out[name] = deq.to(g.dtype)
        error[name] = corrected - deq
    return out, CompressionState(error=error)
