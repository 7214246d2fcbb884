"""AdamW with float32 moments, global-norm clipping and a warmup + cosine
learning rate: the port of ``repro/optim/adamw.py``.

The optimiser state mirrors the parameters by name: ``OptState(mu, nu,
count)`` holds float32 ``mu`` and ``nu`` tensors keyed as the model's
``named_parameters`` and an int32 step ``count``. ``adamw_update`` follows
the reference's arithmetic step for step in float32 (clip, bias
correction, decoupled weight decay) and casts the new parameters back to
their dtype. It updates the parameters and the moments IN PLACE (the
reference's jitted step donates its buffers instead) and returns them.

ZeRO-1 (``zero1_pspecs``): the reference's rule for the state's specs,
each parameter's spec plus the data axes on its largest unsharded axis
that they divide, over partition specs as plain tuples keyed by name (a
block's tensors without the reference's leading layer axes, so a tensor
whose only unsharded axis is the reference's stacked layer axis keeps
its moments whole on every data rank). The mesh train step
(``launch.steps``) updates each rank's slice of the moments and of the
parameter with ``adamw_update`` on those slices, the clipping norm
``global_norm(grads, groups)`` of the whole tree (a tensor sharded over
an axis sums its slices over that axis's group; a replicated one counts
once), passed in as ``gnorm``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.collectives import all_reduce

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "zero1_pspecs"]

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


def global_norm(tensors: Tensors,
                groups: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (summed in the
    mapping's order: the reference sums in its pytree's sorted-key order,
    so the two can differ in the last ulp). ``groups``: a tensor's process
    group when it holds a slice of the whole (its part of the sum is summed
    over the group), ``None`` for a whole one."""
    if not groups or all(g is None for g in groups.values()):
        total = sum(torch.sum(torch.square(t.float()))
                    for t in tensors.values())
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    parts: Dict[int, list] = {}
    for name, t in tensors.items():
        g = groups.get(name)
        parts.setdefault(id(g), [g, 0])[1] += torch.sum(
            torch.square(t.float()))
    total = 0
    for g, part in parts.values():
        total = total + (part if g is None else all_reduce(part, g))
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
                 cfg: AdamWConfig, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Tensors, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step over the parameters named in ``grads``. Writes the new
    parameters and moments in place (``params`` may be views: ZeRO-1
    slices); returns (params, new state, {"grad_norm", "lr"}). ``gnorm``:
    the clipping norm when the tensors are slices of the tree
    (``global_norm(grads, groups)`` of the whole gradients)."""
    if gnorm is None:
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


# ---------------------------------------------------------------------------
# ZeRO-1 sharding
# ---------------------------------------------------------------------------

def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a device mesh (``mesh_dim_names`` and
    ``shape``) or of a mapping of sizes."""
    if isinstance(mesh, Mapping):
        return {a: int(n) for a, n in mesh.items()}
    return {a: int(mesh.shape[i]) for i, a in enumerate(mesh.mesh_dim_names)}


def zero1_pspecs(param_pspecs: Mapping[str, tuple],
                 params: Mapping[str, Any], mesh,
                 data_axes: Sequence[str] = ("data",)
                 ) -> Dict[str, tuple]:
    """The optimiser state's specs: each parameter's spec plus the data axes
    on its largest axis that is unsharded and divisible by the data-axis
    size (the reference's rule), as tuples (per dimension ``None``, an
    axis name or a tuple of names). ``params``: tensors or shapes of the
    whole parameters, by name; ``mesh``: a device mesh or its axis sizes.
    A spec already holding a data axis (expert banks sharded over "data")
    stays as it is."""
    sizes = _axis_sizes(mesh)
    data_axes = tuple(data_axes)
    n_data = math.prod(sizes[a] for a in data_axes)
    extra = data_axes if len(data_axes) > 1 else data_axes[0]

    def leaf_spec(spec: tuple, shape: Tuple[int, ...]) -> tuple:
        if len(shape) == 0:
            return tuple(spec)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for e in entries:
            used.update(e if isinstance(e, tuple) else (e,))
        if any(a in used for a in data_axes):
            return tuple(spec)
        best, best_size = -1, 0
        for i, (e, n) in enumerate(zip(entries, shape)):
            if e is None and n % n_data == 0 and n > best_size \
                    and n >= n_data:
                best, best_size = i, n
        if best >= 0:
            entries[best] = extra
        return tuple(entries)

    return {name: leaf_spec(spec, tuple(getattr(params[name], "shape",
                                                params[name])))
            for name, spec in param_pspecs.items()}
