"""Layout wrappers around the attention and SSD kernels, in the model's
layout.

Each op hands the kernel views of the model-layout tensors, which it reads
through their strides: no transpose is copied (the reference's
``repro/kernels/ops.py`` folds q, k and v into ``(B*K, ...)`` copies).
The route is chosen by the tensors' device, in the kernel modules: the
plain PyTorch version on the CPU, the kernel on CUDA or an error. That is
the port's counterpart of the reference's ``interpret_default``: there is
no interpret mode and no switch.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention_folded
from .flash_attention import flash_attention_folded
from .ssd_scan import ssd_intra_folded

__all__ = ["flash_attention", "decode_attention", "ssd_intra"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,K,G,hd); k/v: (B,S,K,hd) -> (B,S,K,G,hd)."""
    o = flash_attention_folded(q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3),
                               v.permute(0, 2, 1, 3), causal=causal,
                               window=window)
    return o.permute(0, 3, 1, 2, 4)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len, return_lse: bool = False):
    """q: (B,K,G,hd); k/v: (B,C,K,hd); valid_len: int -> (B,K,G,hd), and
    with ``return_lse`` the (B,K,G) float32 log-sum-exp."""
    return decode_attention_folded(q, k.permute(0, 2, 1, 3),
                                   v.permute(0, 2, 1, 3), valid_len,
                                   return_lse=return_lse)


def ssd_intra(xc: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
              Cc: torch.Tensor) -> torch.Tensor:
    """xc: (b,c,q,h,p); cum: (b,c,q,h); Bc/Cc: (b,c,q,n), float32 ->
    (b,c,q,h,p). The folded ``(b*c, ...)`` operands are views of these
    (a column slice of the model's fused projection stays a view)."""
    b, c, q, h, p = xc.shape
    n = Bc.shape[-1]
    out = ssd_intra_folded(xc.reshape(b * c, q, h, p),
                           cum.reshape(b * c, q, h),
                           Bc.reshape(b * c, q, n), Cc.reshape(b * c, q, n))
    return out.reshape(b, c, q, h, p)
