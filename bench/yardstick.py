"""The benchmark's fixed arithmetic: the card's published peaks, B5's work
and bytes at a launch's shapes, and the reduction of a device timeline to busy
time and idle gaps. Kept here, apart from the program, so that a change to the
program cannot move its own yardstick. A model's FLOPs and its kernels' launch
shapes are its configuration's: they sit beside its plain reference
(``bench/reference/<reference>.py``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["PEAK_BF16_FLOPS", "PEAK_TF32_FLOPS", "PEAK_HBM_BYTES",
           "ssd_cost", "union_busy", "idle_gaps"]

#: NVIDIA H100 SXM data sheet, dense: bf16 and TF32 tensor-core FLOP/s, HBM3
#: bytes/s (at the 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def ssd_cost(bc: int, q: int, h: int, p: int, n: int) -> Dict[str, int]:
    """B5's work at a launch's shapes, frozen from its ``cost``: ``flops``
    over the causal band's Q(Q+1)/2 pairs of each chunk (the scores C_i.B_j
    once a chunk, 2N each; per head a weight, 3 operations, and P
    multiply-adds) and ``bytes`` (x, cum, B and C read once, the output
    written once, float32)."""
    pairs = q * (q + 1) // 2
    return {"flops": bc * pairs * (2 * n + h * (2 * p + 3)),
            "bytes": 4 * bc * q * (2 * h * p + h + 2 * n)}


def union_busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals`` (start, end), overlaps once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]
