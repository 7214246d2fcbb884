"""int8 error-feedback gradient compression: the port of
``repro/optim/compression.py``.

Per-tensor symmetric quantization, ``scale = max|g| / 127``, rounding half
to even (as ``jnp.round``); the quantization error is kept in a float32
residual and added to the next step's gradient, so nothing is dropped for
good. ``compress_error_feedback`` returns the gradients as they would
arrive after an int8 wire, in their own dtype, and the new residual.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

__all__ = ["CompressionState", "compress_error_feedback", "quantize_int8",
           "dequantize_int8", "init_compression"]


class CompressionState(NamedTuple):
    error: Dict[str, torch.Tensor]      # float32 residual, by name


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale ()) of ``g``."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)) / 127.0, min=1e-30)
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
                            state: CompressionState
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       CompressionState]:
    """(decompressed grads, new residual state): each gradient plus its
    residual is quantized to int8 and back; what rounding lost is the next
    residual."""
    out, error = {}, {}
    for name, g in grads.items():
        corrected = g.float() + state.error[name]
        deq = dequantize_int8(*quantize_int8(corrected))
        out[name] = deq.to(g.dtype)
        error[name] = corrected - deq
    return out, CompressionState(error=error)
