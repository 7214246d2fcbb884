"""Algorithm-2 swarm replay: the CUDA kernel's wrapper and its plain
PyTorch version.

The PSO-GA fitness hot path scores every particle (server-assignment
vector) of a swarm against a padded problem once per iteration. The
hand-written Hopper kernel (``csrc/schedule_sim.cu``, the port of the
Pallas kernel ``repro/kernels/schedule_sim.py::_schedule_kernel``) walks
the layers of every particle in one launch; ``schedule_replay_plain`` is
the same arithmetic as a plain PyTorch loop over layers with the particle
axis inside each op, used on the CPU and to check the kernel on the card.

Both take the padded-problem layout of ``core.simulator.PaddedProblem``
with a leading fleet axis N on every array:

  * ``order (N, max_p)`` i32 topological order, padded -1 (a no-op step);
  * ``compute (N, max_p)`` f32; ``parent_idx/parent_mb (N, max_p, max_in)``
    i32/f32 and ``child_idx/child_mb (N, max_p, max_out)``, padded -1/0;
  * ``app_id (N, max_p)`` i32; ``deadline (N, max_apps)`` f32 (+inf pad);
    ``pinned (N, max_p)`` i32 (-1 = free);
  * ``power, cost_per_sec (N, S)`` f32; ``inv_bw, tran_cost (N, S, S)``
    f32; ``link_ok (N, S, S)`` bool;
  * ``X (N, P, max_p)`` i32 server assignments.

They return per particle ``(total_cost (N, P) f32, feasible (N, P) bool,
time_sum (N, P) f32)``, where ``time_sum`` is the sum of the apps'
completion times (the Case-3 fitness input, Eq. 16). Feasibility folds
deadlines, pins and forbidden links.

``schedule_replay`` picks by the tensors' device: plain on the CPU, the
kernel on CUDA (or it raises); there is no fallback between the two. Its
``launches`` attribute counts kernel launches.

Every float sum in the plain version runs in the kernel's order (over
steps, then parents or children, then servers, then apps), so padded
entries, appended after the real ones, add exact zeros: results are
invariant under any legal padding, and the kernel (built with
``--fmad=false``) computes the same roundings.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

__all__ = ["schedule_replay", "schedule_replay_plain", "replay_plain",
           "ReplayState", "Phase1", "phase1", "MAX_SMEM_BYTES"]

#: dynamic shared memory one H100 block can opt in to (227 KB)
MAX_SMEM_BYTES = 232_448


class ReplayState(NamedTuple):
    """Everything the plain replay computes, fleet axis first."""
    end: torch.Tensor          # (N, P, max_p) per-layer completion time
    app_completion: torch.Tensor  # (N, P, max_apps), clamped at 0
    comp_cost: torch.Tensor    # (N, P) rental $
    trans_cost: torch.Tensor   # (N, P) transmission $
    feasible: torch.Tensor     # (N, P) bool


def _seq_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (the kernel's order)."""
    out = t[..., 0]
    for k in range(1, t.shape[-1]):
        out = out + t[..., k]
    return out


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table (N, K)`` gathered at ``idx (N, ...)`` -> ``(N, ...)``."""
    n = idx.shape[0]
    return table.gather(1, idx.reshape(n, -1)).reshape(idx.shape)


class Phase1(NamedTuple):
    """The carry-independent quantities of every step, step axis L."""
    srv: torch.Tensor          # (N, P, L) server of the step's layer
    exe: torch.Tensor          # (N, P, L) execution time
    tt: torch.Tensor           # (N, P, L, max_in) incoming transfer times
    pm: torch.Tensor           # (N, 1, L, max_in) real parent mask
    psafe: torch.Tensor        # (N, L, max_in) parent layer ids, 0 if none
    max_trans: torch.Tensor    # (N, P, L)
    tstep: torch.Tensor        # (N, P, L) transmission $ of the step
    out_t: torch.Tensor        # (N, P, L) outgoing transfer time
    bad: torch.Tensor          # (N, P) a forbidden link is used
    pin_ok: torch.Tensor       # (N, P) every pin honoured


def phase1(jsafe, valid, compute, parent_idx, parent_mb, child_idx,
           child_mb, pinned, power, inv_bw, tran_cost, link_ok, X
           ) -> Phase1:
    """Per-step quantities for the layers ``jsafe (N, L)`` (masked by
    ``valid``), in one vectorized pass: topo positions for the zero-load
    replay, layer ids for the traffic replay. Sums over parents and
    children run left to right, the kernels' order."""
    N, P, max_p = X.shape
    S = power.shape[-1]
    L = jsafe.shape[-1]
    max_in, max_out = parent_idx.shape[-1], child_idx.shape[-1]
    Xl = X.long()
    srv = Xl.gather(2, jsafe[:, None, :].expand(N, P, L))    # (N, P, L)
    exe = compute.gather(1, jsafe)[:, None, :] / _take(power, srv)

    def rows(table, width):                     # (N, L, width) by step
        return table.gather(1, jsafe[..., None].expand(N, L, width))

    pars = rows(parent_idx, max_in).long()
    pmask = (pars >= 0) & valid[..., None]                   # (N, L, in)
    psafe = torch.where(pmask, pars, 0)
    psrv = Xl.gather(2, psafe.reshape(N, 1, -1).expand(N, P, -1)).reshape(
        N, P, L, max_in)
    mb = rows(parent_mb, max_in)[:, None]                    # (N, 1, L, in)
    pair_in = psrv * S + srv[..., None]
    flat = lambda m: m.reshape(N, S * S)
    tt = mb * _take(flat(inv_bw), pair_in)                   # (N, P, L, in)
    pm = pmask[:, None]
    max_trans = torch.where(pm, tt, 0.0).amax(-1)            # (N, P, L)
    tstep = _seq_sum(torch.where(pm, _take(flat(tran_cost), pair_in) * mb,
                                 0.0))
    link = flat(link_ok.to(torch.bool))
    bad = (pm & ~_take(link, pair_in) & (psrv != srv[..., None])).flatten(
        2).any(-1)                                           # (N, P)

    kids = rows(child_idx, max_out).long()
    kmask = ((kids >= 0) & valid[..., None])[:, None]        # (N, 1, L, out)
    ksafe = torch.where(kmask[:, 0], kids, 0)
    ksrv = Xl.gather(2, ksafe.reshape(N, 1, -1).expand(N, P, -1)).reshape(
        N, P, L, max_out)
    pair_out = srv[..., None] * S + ksrv
    out_t = _seq_sum(torch.where(
        kmask, rows(child_mb, max_out)[:, None] * _take(flat(inv_bw), pair_out),
        0.0))
    bad = bad | (kmask & ~_take(link, pair_out)
                 & (ksrv != srv[..., None])).flatten(2).any(-1)
    pin_ok = ((pinned[:, None, :] < 0) | (X == pinned[:, None, :])).all(-1)
    return Phase1(srv=srv, exe=exe, tt=tt, pm=pm, psafe=psafe,
                  max_trans=max_trans, tstep=tstep, out_t=out_t, bad=bad,
                  pin_ok=pin_ok)


def replay_plain(order, compute, parent_idx, parent_mb, child_idx, child_mb,
                 app_id, deadline, pinned, power, cost_per_sec, inv_bw,
                 tran_cost, link_ok, X, *, faithful: bool = True
                 ) -> ReplayState:
    """Algorithm 2 for a fleet of swarms as plain PyTorch ops.

    Phase 1 computes everything that does not depend on the evolving
    server state in one vectorized pass; phase 2 is a loop over the
    ``max_p`` steps whose carry is the per-server lease (and, in
    corrected mode, the per-layer end times the parent gate reads).
    """
    X = X.to(torch.int32)
    N, P, max_p = X.shape
    S = power.shape[-1]
    max_in = parent_idx.shape[-1]
    max_apps = deadline.shape[-1]
    dev = X.device

    # ---- phase 1: carry-independent quantities, whole fleet at once ----
    valid = order >= 0                                       # (N, max_p)
    jsafe = torch.where(valid, order, 0).long()
    ph = phase1(jsafe, valid, compute, parent_idx, parent_mb, child_idx,
                child_mb, pinned, power, inv_bw, tran_cost, link_ok, X)
    srv, exe, tt, pm, psafe = ph.srv, ph.exe, ph.tt, ph.pm, ph.psafe
    max_trans, tstep, out_t = ph.max_trans, ph.tstep, ph.out_t

    # ---- phase 2: the carried recurrence, one step per topo position ----
    lease = torch.zeros((N, P, S), dtype=torch.float32, device=dev)
    end_buf = torch.zeros((N, P, max_p + 1), dtype=torch.float32, device=dev)
    start_seq = torch.empty((N, P, max_p), dtype=torch.float32, device=dev)
    trans = torch.zeros((N, P), dtype=torch.float32, device=dev)
    j_idx = torch.where(valid, jsafe, max_p)     # padded steps -> dummy slot
    for t in range(max_p):
        v = valid[:, t, None, None]                          # (N, 1, 1)
        s_t = srv[:, :, t, None]
        exe_t = exe[:, :, t, None]
        lease_srv = lease.gather(2, s_t)
        if faithful:
            start = lease_srv + max_trans[:, :, t, None]
            new_lease = (lease_srv + exe_t) + out_t[:, :, t, None]
        else:
            ep = end_buf.gather(2, psafe[:, None, t, :].expand(N, P, max_in))
            gate = torch.where(pm[:, :, t], ep + tt[:, :, t], 0.0).amax(
                -1, keepdim=True)
            start = torch.maximum(lease_srv, gate)
            new_lease = (start + exe_t) + out_t[:, :, t, None]
        t_end = start + exe_t
        lease.scatter_(2, s_t, torch.where(v, new_lease, lease_srv))
        end_buf.scatter_(2, j_idx[:, t, None, None].expand(N, P, 1), t_end)
        start_seq[:, :, t] = start[..., 0]
        trans = trans + tstep[:, :, t]
    end = end_buf[..., :max_p]

    # ---- epilogue: order-free min/max, then sums in the kernel's order ----
    inf = torch.tensor(float("inf"), device=dev)
    t_on = torch.full((N, P, S), float("inf"), device=dev).scatter_reduce(
        2, srv, torch.where(valid[:, None, :], start_seq, inf), "amin")
    used = ~torch.isinf(t_on)
    t_on_safe = torch.where(used, t_on, 0.0)
    comp = _seq_sum(torch.where(
        used, cost_per_sec[:, None, :] * (lease - t_on_safe), 0.0))
    appc = torch.zeros((N, P, max_apps), dtype=torch.float32,
                       device=dev).scatter_reduce(
        2, app_id.long()[:, None, :].expand(N, P, max_p), end, "amax")
    feasible = (appc <= deadline[:, None, :]).all(-1) & ph.pin_ok \
        & ~ph.bad
    return ReplayState(end=end, app_completion=appc, comp_cost=comp,
                       trans_cost=trans, feasible=feasible)


def schedule_replay_plain(order, compute, parent_idx, parent_mb, child_idx,
                          child_mb, app_id, deadline, pinned, power,
                          cost_per_sec, inv_bw, tran_cost, link_ok, X, *,
                          faithful: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: same signature, same outputs."""
    st = replay_plain(order, compute, parent_idx, parent_mb, child_idx,
                      child_mb, app_id, deadline, pinned, power, cost_per_sec,
                      inv_bw, tran_cost, link_ok, X, faithful=faithful)
    return (st.comp_cost + st.trans_cost, st.feasible,
            _seq_sum(st.app_completion))


def schedule_replay(order, compute, parent_idx, parent_mb, child_idx,
                    child_mb, app_id, deadline, pinned, power, cost_per_sec,
                    inv_bw, tran_cost, link_ok, X, *, faithful: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Replay Algorithm 2 for every particle of every fleet problem.

    CPU tensors take ``schedule_replay_plain``; CUDA tensors launch the
    kernel (and raise on anything it does not take)."""
    args = (order, compute, parent_idx, parent_mb, child_idx, child_mb,
            app_id, deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
            link_ok, X)
    if X.device.type == "cpu":
        return schedule_replay_plain(*args, faithful=faithful)
    if X.device.type != "cuda":
        raise ValueError(f"schedule_replay runs on cpu or cuda, not "
                         f"{X.device}")
    return _launch(*args, faithful=faithful)


schedule_replay.launches = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load("schedule_sim")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.schedule_replay_launch.argtypes = [vp] * 19 + [ci] * 9 + [vp]
        lib.schedule_replay_launch.restype = ci
        lib.schedule_replay_smem_bytes.argtypes = [ci, ci]
        lib.schedule_replay_smem_bytes.restype = ctypes.c_size_t
        lib.schedule_replay_error_string.argtypes = [ci]
        lib.schedule_replay_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(order, compute, parent_idx, parent_mb, child_idx, child_mb,
            app_id, deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
            link_ok, X, *, faithful: bool):
    dev = X.device
    if X.dim() != 3:
        raise ValueError(f"X must be (N, P, max_p), got {tuple(X.shape)}")
    N, P, max_p = X.shape
    S = power.shape[-1]
    max_in, max_out = parent_idx.shape[-1], child_idx.shape[-1]
    max_apps = deadline.shape[-1]
    i32, f32 = torch.int32, torch.float32
    _check("X", X, i32, (N, P, max_p), dev)
    for name, t, dt, shape in (
            ("order", order, i32, (N, max_p)),
            ("compute", compute, f32, (N, max_p)),
            ("parent_idx", parent_idx, i32, (N, max_p, max_in)),
            ("parent_mb", parent_mb, f32, (N, max_p, max_in)),
            ("child_idx", child_idx, i32, (N, max_p, max_out)),
            ("child_mb", child_mb, f32, (N, max_p, max_out)),
            ("app_id", app_id, i32, (N, max_p)),
            ("deadline", deadline, f32, (N, max_apps)),
            ("pinned", pinned, i32, (N, max_p)),
            ("power", power, f32, (N, S)),
            ("cost_per_sec", cost_per_sec, f32, (N, S)),
            ("inv_bw", inv_bw, f32, (N, S, S)),
            ("tran_cost", tran_cost, f32, (N, S, S)),
            ("link_ok", link_ok, torch.bool, (N, S, S))):
        _check(name, t, dt, shape, dev)
    total = torch.empty((N, P), dtype=f32, device=dev)
    feas = torch.empty((N, P), dtype=torch.bool, device=dev)
    tsum = torch.empty((N, P), dtype=f32, device=dev)
    if N == 0 or P == 0:
        return total, feas, tsum
    lib = _lib()
    smem = lib.schedule_replay_smem_bytes(S, max_apps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{S} servers and {max_apps} apps need {smem} bytes "
                         f"of shared memory; a block has {MAX_SMEM_BYTES}")
    # genes layer-major, particles padded to whole warps: coalesced loads
    P_pad = -(-P // 32) * 32
    Xt = torch.zeros((N, max_p, P_pad), dtype=i32, device=dev)
    Xt[:, :, :P] = X.transpose(1, 2)
    end = torch.empty((N, max_p, P_pad) if not faithful else (1,),
                      dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (
        Xt, order, compute, parent_idx, parent_mb, child_idx, child_mb,
        app_id, deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
        link_ok.view(torch.uint8), end, total, feas, tsum)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    schedule_replay.launches += 1
    err = lib.schedule_replay_launch(
        *ptrs, N, P, P_pad, max_p, max_in, max_out, S, max_apps,
        int(faithful), stream)
    if err != 0:
        raise RuntimeError(
            "schedule_replay kernel launch failed: "
            f"{lib.schedule_replay_error_string(err).decode()}")
    return total, feas, tsum
