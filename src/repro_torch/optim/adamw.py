"""AdamW with float32 moments, global-norm clipping and a warmup + cosine
learning rate: the port of ``repro/optim/adamw.py``.

The optimiser state mirrors the parameters by name: ``OptState(mu, nu,
count)`` holds float32 ``mu`` and ``nu`` tensors keyed as the model's
``named_parameters`` and an int32 step ``count``. ``adamw_update`` follows
the reference's arithmetic step for step in float32 (clip, bias
correction, decoupled weight decay) and casts the new parameters back to
their dtype. It updates the parameters and the moments IN PLACE (the
reference's jitted step donates its buffers instead) and returns them.
The reference's ZeRO-1 sharding of the state (``zero1_pspecs``) waits for
ROADMAP queue A item 13c.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]     # float32 first moment, by name
    nu: Dict[str, torch.Tensor]     # float32 second moment, by name
    count: torch.Tensor             # () int32: steps taken


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``min_lr_ratio · lr`` at ``total_steps``; float32, as the reference."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (summed in the
    mapping's order: the reference sums in its pytree's sorted-key order,
    so the two can differ in the last ulp)."""
    total = sum(torch.sum(torch.square(t.float())) for t in tensors.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_init(params: Tensors) -> OptState:
    """Zero float32 moments beside each parameter, count 0."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(mu=zeros, nu={n: z.clone() for n, z in zeros.items()},
                    count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adamw_update(grads: Tensors, state: OptState, params: Tensors,
                 cfg: AdamWConfig
                 ) -> Tuple[Tensors, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step over the parameters named in ``grads``. Writes the new
    parameters and moments in place; returns (params, new state,
    {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    count = state.count + 1
    lr = cosine_schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    for name, g in grads.items():
        m, v, p = state.mu[name], state.nu[name], params[name]
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    return params, OptState(state.mu, state.nu, count), \
        {"grad_norm": gnorm, "lr": lr}
