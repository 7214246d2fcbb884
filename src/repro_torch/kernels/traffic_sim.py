"""Queue-aware FCFS traffic replay: the CUDA kernel's wrapper and its plain
PyTorch version.

A traffic-aware PSO-GA solve scores every particle of every iteration
under R request copies of the schedule for each of M Monte-Carlo arrival
draws. The hand-written Hopper kernel (``csrc/traffic_sim.cu``, the port of
the Pallas kernel ``repro/kernels/traffic_sim.py::_traffic_kernel``) walks
the merged event order of every (problem, draw, particle) in one launch;
``traffic_replay_plain`` is the same walk as plain PyTorch ops with the
particle axis inside each op, used on the CPU and to check the kernel on
the card.

Both take the zero-load replay's 14 problem arrays and genes (see
``kernels/schedule_sim.py``, leading fleet axis N) plus the merged order,
built once per solve by ``core.traffic.traffic_inputs``:

  * ``slot_m (N, M, T)`` i32, ``T = R * max_p``: the merged steps of each
    draw, step = ``r * max_p + layer id``; the first ``n_valid`` are real
    (sorted by arrival, then slot), the rest are never read;
  * ``arr_m (N, M, T)`` f32 arrival time of each step's request;
  * ``n_valid (N, M)`` i32 real steps of each draw;
  * ``arr2 (N, M, max_apps, R)`` f32 request arrivals, 0 where not real;
  * ``req_valid (N, M, max_apps, R)`` bool real request slots.

They return ``(total (N, M, P), miss_rate (N, M, P), lat_sum (N, M, P),
static_ok (N, P), latency)``: load-adjusted cost (rental over the whole
horizon plus transmission of every request copy), deadline-miss rate, the
sum of request latencies, pins-and-links feasibility, and ``latency``, the
``(N, M, P, max_apps, R)`` buffer passed in (filled with completion minus
arrival, 0 for slots that are not real) or None when none was passed.

``traffic_replay`` picks by the tensors' device: plain on the CPU, the
kernel on CUDA (or it raises); there is no fallback between the two. Its
``launches`` attribute counts kernel launches. Every float sum of the plain
version runs in the kernel's order, so the two agree to the rounding.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .schedule_sim import MAX_SMEM_BYTES, _check, _seq_sum, phase1

__all__ = ["traffic_replay", "traffic_replay_plain"]


def _cat(t: torch.Tensor, fill, dim: int) -> torch.Tensor:
    """Append one ``fill`` entry along ``dim``: the dummy no-op column."""
    shape = list(t.shape)
    shape[dim] = 1
    return torch.cat([t, torch.full(shape, fill, dtype=t.dtype,
                                    device=t.device)], dim)


def _draws(slot_m: torch.Tensor) -> int:
    """M, the arrival draws of ``slot_m (N, M, T)``: at least one, since
    ``static_ok`` is reported per problem only beside per-draw results."""
    if slot_m.dim() != 3 or slot_m.shape[1] == 0:
        raise ValueError(f"slot_m must be (N, M, T) with M >= 1 arrival "
                         f"draws; got {tuple(slot_m.shape)}")
    return slot_m.shape[1]


def traffic_replay_plain(order, compute, parent_idx, parent_mb, child_idx,
                         child_mb, app_id, deadline, pinned, power,
                         cost_per_sec, inv_bw, tran_cost, link_ok, X, slot_m,
                         arr_m, n_valid, arr2, req_valid, *,
                         faithful: bool = True,
                         latency: Optional[torch.Tensor] = None):
    """The kernel's plain PyTorch version: same arguments, same outputs.

    Phase 1 computes every layer's carry-independent quantities by layer
    id; the walk then runs ``max(n_valid)`` steps for all (problem, draw)
    lanes at once. A lane past its own ``n_valid`` steps a dummy no-op
    layer (server, end slot and completion column past the real ones,
    zero transmission), so its state is frozen exactly."""
    X = X.to(torch.int32)
    N, P, max_p = X.shape
    M = _draws(slot_m)
    A, R = arr2.shape[-2:]
    S = power.shape[-1]
    max_in = parent_idx.shape[-1]
    dev = X.device
    f32 = torch.float32

    # ---- phase 1 by layer id, plus a dummy no-op layer at id max_p ----
    ids = torch.arange(max_p, device=dev).expand(N, max_p)
    valid_id = ids < (order >= 0).sum(-1, keepdim=True)
    ph = phase1(ids, valid_id, compute, parent_idx, parent_mb, child_idx,
                child_mb, pinned, power, inv_bw, tran_cost, link_ok, X)
    srv = _cat(ph.srv, S, 2)                                 # (N, P, L+1)
    exe, mt, ot, ts = (_cat(t, 0.0, 2) for t in (ph.exe, ph.max_trans,
                                                 ph.out_t, ph.tstep))
    tt = _cat(ph.tt, 0.0, 2)                                 # (N, P, L+1, in)
    pm = _cat(ph.pm[:, 0], False, 1)                         # (N, L+1, in)
    psafe = _cat(ph.psafe, 0, 1)

    # ---- per-step indices of every lane; steps past n_valid -> dummy ----
    Tn = int(n_valid.max()) if n_valid.numel() else 0
    active = torch.arange(Tn, device=dev) < n_valid[..., None]  # (N, M, Tn)
    slot = slot_m[..., :Tn].long()
    r = slot // max_p
    j = slot - r * max_p
    j_step = torch.where(active, j, max_p)
    end_slot = torch.where(active, slot, R * max_p)
    app = app_id.long().gather(1, j.reshape(N, -1)).reshape(j.shape)
    c_step = torch.where(active, app * R + r, A * R)
    a_step = arr_m[..., :Tn]
    eidx = r[..., None] * max_p + psafe.gather(
        1, j_step.reshape(N, -1, 1).expand(-1, -1, max_in)).reshape(
        N, M, Tn, max_in)
    pm_step = pm.gather(1, j_step.reshape(N, -1, 1).expand(
        -1, -1, max_in)).reshape(N, M, Tn, max_in)

    # ---- the walk ----
    lease = torch.zeros((N, M, P, S + 1), dtype=f32, device=dev)
    t_on = torch.full((N, M, P, S + 1), float("inf"), device=dev)
    appc = torch.zeros((N, M, P, A * R + 1), dtype=f32, device=dev)
    end = torch.zeros((N, M, P, R * max_p + 1), dtype=f32, device=dev)
    trans = torch.zeros((N, M, P), dtype=f32, device=dev)
    L1 = max_p + 1
    for t in range(Tn):
        gi = j_step[:, :, t, None, None].expand(N, M, P, 1)

        def g(tab):                              # (N, P, L+1) -> (N, M, P, 1)
            return tab[:, None].expand(N, M, P, L1).gather(3, gi)

        s = g(srv)
        exe_t, ot_t = g(exe), g(ot)
        a = a_step[:, :, t, None, None]
        lease_srv = lease.gather(3, s)
        if faithful:
            base = torch.maximum(lease_srv, a)
            start = base + g(mt)
            new_lease = (base + exe_t) + ot_t
        else:
            ep = end.gather(3, eidx[:, :, t, None, :].expand(N, M, P, max_in))
            tt_t = tt[:, None].expand(N, M, P, L1, max_in).gather(
                3, j_step[:, :, t, None, None, None].expand(
                    N, M, P, 1, max_in))[:, :, :, 0]
            gate = torch.where(pm_step[:, :, t, None, :], ep + tt_t,
                               0.0).amax(-1, keepdim=True)
            start = torch.maximum(lease_srv, torch.maximum(gate, a))
            new_lease = (start + exe_t) + ot_t
        t_end = start + exe_t
        lease.scatter_(3, s, new_lease)
        t_on.scatter_reduce_(3, s, start, "amin")
        appc.scatter_reduce_(3, c_step[:, :, t, None, None].expand(
            N, M, P, 1), t_end, "amax")
        if not faithful:
            end.scatter_(3, end_slot[:, :, t, None, None].expand(
                N, M, P, 1), t_end)
        trans = trans + g(ts)[..., 0]

    # ---- epilogue: servers, then apps x requests, in the kernel's order ----
    t_on, lease = t_on[..., :S], lease[..., :S]
    used = ~torch.isinf(t_on)
    comp = _seq_sum(torch.where(
        used, cost_per_sec[:, None, None, :]
        * (lease - torch.where(used, t_on, 0.0)), 0.0))
    rv = req_valid.reshape(N, M, 1, A * R)
    lat = torch.where(rv, appc[..., :A * R] - arr2.reshape(N, M, 1, A * R),
                      0.0)
    dl = deadline.repeat_interleave(R, -1)[:, None, None, :]
    misses = _seq_sum((rv & (lat > dl)).to(f32))
    n_req = rv.to(f32).sum(-1).clamp_min(1.0)
    if latency is not None:
        latency.copy_(lat.reshape(N, M, P, A, R))
    return (comp + trans, misses / n_req, _seq_sum(lat),
            ph.pin_ok & ~ph.bad, latency)


def traffic_replay(order, compute, parent_idx, parent_mb, child_idx,
                   child_mb, app_id, deadline, pinned, power, cost_per_sec,
                   inv_bw, tran_cost, link_ok, X, slot_m, arr_m, n_valid,
                   arr2, req_valid, *, faithful: bool = True,
                   latency: Optional[torch.Tensor] = None):
    """Replay every particle of every fleet problem under every arrival
    draw.

    CPU tensors take ``traffic_replay_plain``; CUDA tensors launch the
    kernel (and raise on anything it does not take)."""
    args = (order, compute, parent_idx, parent_mb, child_idx, child_mb,
            app_id, deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
            link_ok, X, slot_m, arr_m, n_valid, arr2, req_valid)
    if X.device.type == "cpu":
        return traffic_replay_plain(*args, faithful=faithful, latency=latency)
    if X.device.type != "cuda":
        raise ValueError(f"traffic_replay runs on cpu or cuda, not "
                         f"{X.device}")
    return _launch(*args, faithful=faithful, latency=latency)


traffic_replay.launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load("traffic_sim")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.traffic_replay_launch.argtypes = [vp] * 26 + [ci] * 11 + [vp]
        lib.traffic_replay_launch.restype = ci
        lib.traffic_replay_smem_bytes.argtypes = [ci, ci, ci]
        lib.traffic_replay_smem_bytes.restype = ctypes.c_size_t
        lib.traffic_replay_error_string.argtypes = [ci]
        lib.traffic_replay_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(order, compute, parent_idx, parent_mb, child_idx, child_mb,
            app_id, deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
            link_ok, X, slot_m, arr_m, n_valid, arr2, req_valid, *,
            faithful: bool, latency: Optional[torch.Tensor]):
    dev = X.device
    if X.dim() != 3 or slot_m.dim() != 3 or arr2.dim() != 4:
        raise ValueError(f"X must be (N, P, max_p), slot_m (N, M, T) and "
                         f"arr2 (N, M, max_apps, R); got {tuple(X.shape)}, "
                         f"{tuple(slot_m.shape)}, {tuple(arr2.shape)}")
    N, P, max_p = X.shape
    M = _draws(slot_m)
    A, R = arr2.shape[-2:]
    S = power.shape[-1]
    max_in, max_out = parent_idx.shape[-1], child_idx.shape[-1]
    T = R * max_p
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
            ("deadline", deadline, f32, (N, A)),
            ("pinned", pinned, i32, (N, max_p)),
            ("power", power, f32, (N, S)),
            ("cost_per_sec", cost_per_sec, f32, (N, S)),
            ("inv_bw", inv_bw, f32, (N, S, S)),
            ("tran_cost", tran_cost, f32, (N, S, S)),
            ("link_ok", link_ok, torch.bool, (N, S, S)),
            ("slot_m", slot_m, i32, (N, M, T)),
            ("arr_m", arr_m, f32, (N, M, T)),
            ("n_valid", n_valid, i32, (N, M)),
            ("arr2", arr2, f32, (N, M, A, R)),
            ("req_valid", req_valid, torch.bool, (N, M, A, R))):
        _check(name, t, dt, shape, dev)
    if latency is not None:
        _check("latency", latency, f32, (N, M, P, A, R), dev)
    total = torch.empty((N, M, P), dtype=f32, device=dev)
    miss = torch.empty((N, M, P), dtype=f32, device=dev)
    lat_sum = torch.empty((N, M, P), dtype=f32, device=dev)
    static_ok = torch.empty((N, P), dtype=torch.bool, device=dev)
    if N == 0 or P == 0:
        return total, miss, lat_sum, static_ok, latency
    lib = _lib()
    smem = lib.traffic_replay_smem_bytes(S, A, R)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{S} servers and {A} apps x {R} requests need "
                         f"{smem} bytes of shared memory; a block has "
                         f"{MAX_SMEM_BYTES}")
    # genes layer-major, particles padded to whole warps: coalesced loads
    P_pad = -(-P // 32) * 32
    Xt = torch.zeros((N, max_p, P_pad), dtype=i32, device=dev)
    Xt[:, :, :P] = X.transpose(1, 2)
    end = torch.zeros((N, M, T, P_pad) if not faithful else (1,),
                      dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (
        Xt, order, compute, parent_idx, parent_mb, child_idx, child_mb,
        app_id, deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
        link_ok.view(torch.uint8), slot_m, arr_m, n_valid, arr2,
        req_valid.view(torch.uint8), end, total, miss, lat_sum,
        static_ok.view(torch.uint8))]
    ptrs.append(None if latency is None else latency.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    traffic_replay.launches += 1
    err = lib.traffic_replay_launch(
        *ptrs, N, M, P, P_pad, max_p, max_in, max_out, S, A, R,
        int(faithful), stream)
    if err != 0:
        raise RuntimeError(
            "traffic_replay kernel launch failed: "
            f"{lib.traffic_replay_error_string(err).decode()}")
    return total, miss, lat_sum, static_ok, latency
