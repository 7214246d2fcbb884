"""Schedule simulator — paper Algorithm 2 ("map from a particle to DNN
layers offloading"), ported from ``repro.core.simulator``.

Given an assignment vector ``x`` (server index per layer) the simulator
replays the offloading: layers execute in a fixed topological order, each
server is a serial queue, incoming datasets pay ``∂ / ℓ`` transfer time,
and the server stays busy for its outgoing transfers (Alg. 2 line 21).

Two fidelity modes (DESIGN.md §2):
  * ``faithful=True``  — the printed recurrence, verbatim:
        T_start = T_lease(s) + maxTrans;  T_lease(s) += exe + transfer_out
  * ``faithful=False`` — "corrected": a layer cannot start before its
    parents finished and shipped:
        T_start = max(T_lease(s), max_p(T_end(p) + trans_p))
        T_lease(s) = T_end + transfer_out

Cost model (Eq. 8): per-server rental c_com · (T_off − T_on) plus
per-edge transmission c_tran · ∂ for every edge crossing two servers.
Missing links are clamped to ``MIN_BW`` MB/s, so infeasible placements get
enormous but finite times.

``SimProblem`` and the numpy oracle ``simulate_np`` are copies of the
reference. The tensor path works on the padded representation
(``PaddedProblem``): layers padded to ``max_p`` (``order`` padded -1, a
zero-cost no-op), servers to ``max_S`` (unreachable), apps to ``max_apps``
(deadline +inf). Every field may carry a leading fleet axis, which
``core.batch`` stacks. ``simulate_swarm`` is the plain swarm replay;
``core.fitness`` routes a CUDA problem to the kernel instead.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.schedule_sim import replay_plain, schedule_replay_plain
from .dag import LayerDAG, topological_order
from .device import resolve_device
from .environment import Environment

MIN_BW = 1e-9   # MB/s stand-in for "no link"
__all__ = ["SimResult", "SimProblem", "PaddedProblem", "pad_problem",
           "padded_from_arrays", "stack_problems", "kernel_args",
           "simulate_padded", "simulate_swarm", "simulate_np",
           "build_simulator", "MIN_BW"]


class SimResult(NamedTuple):
    """numpy values from ``simulate_np``, tensors from ``simulate_padded``;
    scalar fields are 0-d."""
    end_times: object             # (p,) per-layer completion time
    app_completion: object        # (n_apps,) T_i^comp
    comp_cost: object             # $ rental
    trans_cost: object            # $ transmission
    total_cost: object            # Eq. 8
    feasible: object              # bool: all deadlines met AND pins honored
    makespan: object              # max end time


@dataclasses.dataclass(frozen=True)
class SimProblem:
    """Static numpy arrays describing (dag, env) for the simulator."""
    compute: np.ndarray       # (p,)
    order: np.ndarray         # (p,) topological order
    parent_idx: np.ndarray    # (p, max_in) padded -1
    parent_mb: np.ndarray     # (p, max_in)
    child_idx: np.ndarray     # (p, max_out) padded -1
    child_mb: np.ndarray      # (p, max_out)
    app_id: np.ndarray        # (p,)
    deadline: np.ndarray      # (n_apps,)
    pinned: np.ndarray        # (p,)
    power: np.ndarray         # (S,)
    cost_per_sec: np.ndarray  # (S,)
    inv_bw: np.ndarray        # (S, S) seconds per MB (0 on diagonal)
    tran_cost: np.ndarray     # (S, S) $/MB (0 on diagonal)
    link_ok: np.ndarray       # (S, S) bool

    @property
    def num_layers(self) -> int:
        return int(self.compute.shape[0])

    @property
    def num_servers(self) -> int:
        return int(self.power.shape[0])

    @property
    def num_apps(self) -> int:
        return int(self.deadline.shape[0])

    @staticmethod
    def build(dag: LayerDAG, env: Environment) -> "SimProblem":
        pi, pm, ci, cm = dag.padded_relatives()
        bw = np.where(env.bandwidth <= 0.0, MIN_BW, env.bandwidth)
        inv_bw = 1.0 / bw                     # diagonal is 1/inf = 0
        return SimProblem(
            compute=dag.compute, order=topological_order(dag),
            parent_idx=pi, parent_mb=pm, child_idx=ci, child_mb=cm,
            app_id=dag.app_id, deadline=dag.deadline, pinned=dag.pinned,
            power=env.power, cost_per_sec=env.cost_per_sec,
            inv_bw=inv_bw, tran_cost=env.tran_cost,
            link_ok=env.bandwidth > 0.0)


# ---------------------------------------------------------------------------
# numpy reference (oracle for tests), copied from the reference package
# ---------------------------------------------------------------------------

def simulate_np(prob: SimProblem, x: np.ndarray, faithful: bool = True
                ) -> SimResult:
    x = np.asarray(x, np.int64)
    p, s = prob.num_layers, prob.num_servers
    lease = np.zeros(s)
    t_on = np.full(s, np.inf)
    used = np.zeros(s, bool)
    end = np.zeros(p)
    trans_cost = 0.0
    link_violation = False

    for j in prob.order:
        srv = x[j]
        exe = prob.compute[j] / prob.power[srv]
        pars = prob.parent_idx[j]
        mask = pars >= 0
        max_trans = 0.0
        parent_gate = 0.0
        for k in np.nonzero(mask)[0]:
            pj = pars[k]
            mb = prob.parent_mb[j, k]
            t = mb * prob.inv_bw[x[pj], srv]
            if not prob.link_ok[x[pj], srv] and x[pj] != srv:
                link_violation = True
            max_trans = max(max_trans, t)
            parent_gate = max(parent_gate, end[pj] + t)
            trans_cost += prob.tran_cost[x[pj], srv] * mb
        if faithful:
            start = lease[srv] + max_trans
        else:
            start = max(lease[srv], parent_gate)
        t_end = start + exe
        end[j] = t_end
        t_on[srv] = min(t_on[srv], start)
        used[srv] = True
        transfer_out = 0.0
        cidx = prob.child_idx[j]
        for k in np.nonzero(cidx >= 0)[0]:
            transfer_out += prob.child_mb[j, k] * prob.inv_bw[srv, x[cidx[k]]]
        if faithful:
            lease[srv] = lease[srv] + exe + transfer_out   # line 21, verbatim
        else:
            lease[srv] = t_end + transfer_out

    app_completion = np.zeros(prob.num_apps)
    np.maximum.at(app_completion, prob.app_id, end)
    comp_cost = float(np.sum(np.where(used, prob.cost_per_sec * (lease - np.where(np.isinf(t_on), 0.0, t_on)), 0.0)))
    pin_ok = np.all((prob.pinned < 0) | (x == prob.pinned))
    feasible = bool(np.all(app_completion <= prob.deadline) and pin_ok
                    and not link_violation)
    total = comp_cost + trans_cost
    return SimResult(end_times=end, app_completion=app_completion,
                     comp_cost=np.float64(comp_cost),
                     trans_cost=np.float64(trans_cost),
                     total_cost=np.float64(total),
                     feasible=np.bool_(feasible),
                     makespan=np.float64(end.max() if p else 0.0))


# ---------------------------------------------------------------------------
# tensor path — padded representation
# ---------------------------------------------------------------------------

_FLOAT_FIELDS = ("compute", "parent_mb", "child_mb", "deadline", "power",
                 "cost_per_sec", "inv_bw", "tran_cost")


class PaddedProblem(NamedTuple):
    """Device tensors for one padded problem, or for N of them stacked
    along a leading fleet axis (``core.batch``). Padding is appended after
    the real entries:
      * layers  -> ``max_p``:   ``order`` -1 (a no-op step), compute 0,
        pinned -1, parent/child idx -1;
      * servers -> ``max_S``:   power 1, cost 0, link_ok False, inv_bw
        1/MIN_BW — the solver never emits genes >= ``num_servers``;
      * apps    -> ``max_apps``: deadline +inf (an empty app's completion
        clamps to 0).
    ``num_layers`` / ``num_servers`` / ``num_apps`` are the TRUE counts
    (int32, 0-d or (N,)), so PSO-GA draws its bounds from the real sizes.
    """
    compute: torch.Tensor        # (max_p,) f32
    order: torch.Tensor          # (max_p,) i32, padded -1
    parent_idx: torch.Tensor     # (max_p, max_in) i32, padded -1
    parent_mb: torch.Tensor      # (max_p, max_in) f32
    child_idx: torch.Tensor      # (max_p, max_out) i32, padded -1
    child_mb: torch.Tensor       # (max_p, max_out) f32
    app_id: torch.Tensor         # (max_p,) i32
    deadline: torch.Tensor       # (max_apps,) f32, padded +inf
    pinned: torch.Tensor         # (max_p,) i32, padded -1
    power: torch.Tensor          # (max_S,) f32
    cost_per_sec: torch.Tensor   # (max_S,) f32
    inv_bw: torch.Tensor         # (max_S, max_S) f32
    tran_cost: torch.Tensor      # (max_S, max_S) f32
    link_ok: torch.Tensor        # (max_S, max_S) bool
    num_layers: torch.Tensor     # () i32 — true p
    num_servers: torch.Tensor    # () i32 — true S
    num_apps: torch.Tensor       # () i32 — true n_apps

    @property
    def max_layers(self) -> int:
        return int(self.compute.shape[-1])

    @property
    def max_servers(self) -> int:
        return int(self.power.shape[-1])

    @property
    def stacked(self) -> bool:
        """True when the fields carry a leading fleet axis."""
        return self.compute.dim() == 2

    @property
    def device(self) -> torch.device:
        return self.compute.device


def padded_from_arrays(src, device: Optional[Union[str, torch.device]] = None
                       ) -> PaddedProblem:
    """A ``PaddedProblem`` from any object with the same field names whose
    values numpy can read — e.g. the reference package's ``PaddedProblem``
    — in float32 / int32 / bool. Tests use it to hand both packages
    identical inputs."""
    dev = resolve_device(device)
    out = {}
    for name in PaddedProblem._fields:
        arr = np.asarray(getattr(src, name))
        if name == "link_ok":
            arr = arr.astype(bool)
        elif name in _FLOAT_FIELDS:
            arr = arr.astype(np.float32)
        else:
            arr = arr.astype(np.int32)
        out[name] = torch.as_tensor(arr, device=dev)
    return PaddedProblem(**out)


def pad_problem(prob: SimProblem,
                max_p: Optional[int] = None,
                max_S: Optional[int] = None,
                max_in: Optional[int] = None,
                max_out: Optional[int] = None,
                max_apps: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> PaddedProblem:
    """Embed a ``SimProblem`` into the padded representation on
    ``device`` (``None`` = the card). With all sizes None this is the
    identity embedding; explicit targets are how ``batch.pack_fleet`` pads
    each problem to its bucket. Padded layers are zero-cost no-ops and
    padded servers unreachable, so the result is identical under any legal
    target sizes."""
    dev = resolve_device(device)
    p, s, a = prob.num_layers, prob.num_servers, prob.num_apps
    in0, out0 = prob.parent_idx.shape[1], prob.child_idx.shape[1]
    max_p = p if max_p is None else max_p
    max_S = s if max_S is None else max_S
    max_in = in0 if max_in is None else max_in
    max_out = out0 if max_out is None else max_out
    max_apps = a if max_apps is None else max_apps
    if max_p < p or max_S < s or max_in < in0 or max_out < out0 \
            or max_apps < a:
        raise ValueError("padded sizes smaller than problem sizes")

    def pad(arr, shape, fill, dtype):
        out = np.full(shape, fill, dtype=dtype)
        out[tuple(slice(0, n) for n in arr.shape)] = arr
        return torch.as_tensor(out, device=dev)

    f32, i32 = np.float32, np.int32
    scalar = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return PaddedProblem(
        compute=pad(prob.compute, (max_p,), 0.0, f32),
        order=pad(prob.order, (max_p,), -1, i32),
        parent_idx=pad(prob.parent_idx, (max_p, max_in), -1, i32),
        parent_mb=pad(prob.parent_mb, (max_p, max_in), 0.0, f32),
        child_idx=pad(prob.child_idx, (max_p, max_out), -1, i32),
        child_mb=pad(prob.child_mb, (max_p, max_out), 0.0, f32),
        app_id=pad(prob.app_id, (max_p,), 0, i32),
        deadline=pad(prob.deadline, (max_apps,), np.inf, f32),
        pinned=pad(prob.pinned, (max_p,), -1, i32),
        power=pad(prob.power, (max_S,), 1.0, f32),
        cost_per_sec=pad(prob.cost_per_sec, (max_S,), 0.0, f32),
        inv_bw=pad(prob.inv_bw, (max_S, max_S), 1.0 / MIN_BW, f32),
        tran_cost=pad(prob.tran_cost, (max_S, max_S), 0.0, f32),
        link_ok=pad(prob.link_ok, (max_S, max_S), False, bool),
        num_layers=scalar(p), num_servers=scalar(s), num_apps=scalar(a))


def stack_problems(pps: Sequence[PaddedProblem]) -> PaddedProblem:
    """Stack same-shape padded problems along a new leading fleet axis."""
    return PaddedProblem(*(torch.stack(leaves) for leaves in zip(*pps)))


def kernel_args(pp: PaddedProblem) -> Tuple[torch.Tensor, ...]:
    """The 14 replay inputs in the kernel's argument order, each with a
    leading fleet axis (added when ``pp`` holds a single problem)."""
    fields = (pp.order, pp.compute, pp.parent_idx, pp.parent_mb,
              pp.child_idx, pp.child_mb, pp.app_id, pp.deadline, pp.pinned,
              pp.power, pp.cost_per_sec, pp.inv_bw, pp.tran_cost,
              pp.link_ok)
    if pp.stacked:
        return fields
    return tuple(f.unsqueeze(0) for f in fields)


def simulate_padded(pp: PaddedProblem, x: torch.Tensor,
                    faithful: bool = True) -> SimResult:
    """Algorithm 2 for ONE assignment ``x (max_p,)`` on a single padded
    problem; returns the full ``SimResult`` as tensors (0-d scalars).
    Padded ``order`` entries are no-ops, so the result equals the unpadded
    simulation of the embedded problem."""
    x = torch.as_tensor(x, device=pp.device).to(torch.int32)
    st = replay_plain(*kernel_args(pp), x.reshape(1, 1, -1),
                      faithful=faithful)
    end = st.end[0, 0]
    total = st.comp_cost[0, 0] + st.trans_cost[0, 0]
    return SimResult(end_times=end, app_completion=st.app_completion[0, 0],
                     comp_cost=st.comp_cost[0, 0],
                     trans_cost=st.trans_cost[0, 0], total_cost=total,
                     feasible=st.feasible[0, 0],
                     makespan=end.max() if end.numel() else end.sum())


def simulate_swarm(pp: PaddedProblem, X: torch.Tensor,
                   faithful: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 2 for a whole swarm with plain PyTorch ops: ``X (P,
    max_p)`` (or ``(N, P, max_p)`` for a stacked fleet) -> per-particle
    ``(total_cost, feasible, Σ T_i^comp)``. The same summary as the
    kernel, so ``fitness.make_swarm_fitness`` treats both alike."""
    X = torch.as_tensor(X, device=pp.device).to(torch.int32)
    out = schedule_replay_plain(*kernel_args(pp),
                                X if pp.stacked else X.unsqueeze(0),
                                faithful=faithful)
    return out if pp.stacked else tuple(o[0] for o in out)


def build_simulator(prob: SimProblem, faithful: bool = True,
                    device: Optional[Union[str, torch.device]] = None):
    """``sim(x) -> SimResult`` closed over the unpadded problem."""
    pp = pad_problem(prob, device=device)
    return partial(simulate_padded, pp, faithful=faithful)
