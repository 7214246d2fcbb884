"""The 10 assigned architectures — aggregated from the per-arch modules.

``get(name)`` returns the full config; ``get(name).reduced()`` the smoke
variant used by per-arch CPU smoke tests.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .base import ModelConfig
from .gemma_7b import CONFIG as GEMMA_7B
from .starcoder2_3b import CONFIG as STARCODER2_3B
from .gemma3_27b import CONFIG as GEMMA3_27B
from .qwen3_0p6b import CONFIG as QWEN3_0P6B
from .arctic_480b import CONFIG as ARCTIC_480B
from .mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from .whisper_medium import CONFIG as WHISPER_MEDIUM
from .mamba2_2p7b import CONFIG as MAMBA2_2P7B
from .zamba2_7b import CONFIG as ZAMBA2_7B
from .internvl2_2b import CONFIG as INTERNVL2_2B

__all__ = ["ARCHS", "get", "names"]

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        GEMMA_7B, STARCODER2_3B, GEMMA3_27B, QWEN3_0P6B, ARCTIC_480B,
        MIXTRAL_8X7B, WHISPER_MEDIUM, MAMBA2_2P7B, ZAMBA2_7B, INTERNVL2_2B)
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def names() -> Tuple[str, ...]:
    return tuple(ARCHS.keys())
