"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "backend_name"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises; the
    CPU is used only when the caller names it. ``meta`` (shapes, no
    storage) lets a model be built to take another's weights with
    ``load_state_dict(..., assign=True)``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def backend_name(device: torch.device) -> str:
    """What a solve on ``device`` actually runs: the ``cuda`` kernel or
    the ``cpu`` plain version."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"
