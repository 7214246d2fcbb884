"""Queue-aware FCFS traffic replay: the CUDA kernel's wrapper and its plain
PyTorch version.

A traffic-aware PSO-GA solve scores every particle of every iteration
under R request copies of the schedule for each of M Monte-Carlo arrival
draws. The hand-written Hopper kernel (``csrc/traffic_sim.cu``, the port of
the Pallas kernel ``repro/kernels/traffic_sim.py::_traffic_kernel``) makes
two CUDA launches per call: the carry-free pass that the zero-load replay
runs too (``schedule_sim.phase1`` by topo position, once per problem and
particle), then a walk of every (problem, draw)'s merged order that
gathers each step's row at its layer's topo position and carries the
server leases, the request completions and, in corrected mode, a ring of
the last ``RING`` end times per particle. ``traffic_step_tables`` builds
what the walk shares across particles, once per solve.
``traffic_replay_plain`` is the same walk as plain PyTorch ops with the
particle axis inside each op, used on the CPU and to check the kernel on
the card; ``traffic_ring_plain`` runs the walk's tables, ring and far-read
addressing in plain PyTorch, with any ring, tile and copy distance, for
the CPU tests.

Both take the zero-load replay's 14 problem arrays and genes (see
``kernels/schedule_sim.py``, leading fleet axis N) plus the merged order,
built once per solve by ``core.traffic.traffic_inputs``:

  * ``slot_m (N, M, T)`` i32, ``T = R * max_p``: the merged steps of each
    draw, step = ``r * max_p + layer id``; the first ``n_valid`` are real
    (sorted by arrival, then request slot, then topo position), the rest
    are never read;
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
``launches`` attribute counts calls that launch the kernel (each is one
replay, two CUDA launches). Every float sum of the plain version runs in
the kernel's order, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .schedule_sim import (AHEAD, LOCK, MAX_IN, MAX_SMEM_BYTES, RING, TILE,
                           _check, _memo_tables, _seq_sum, phase1)

__all__ = ["traffic_replay", "traffic_replay_plain", "traffic_ring_plain",
           "traffic_step_tables"]


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


def _epilogue(lease, t_on, appc, trans, cost_per_sec, deadline, arr2,
              req_valid, latency):
    """Sums over servers, then over apps x requests, in the kernel's order:
    ``lease, t_on (N, M, P, S)``, ``appc (N, M, P, max_apps R)``."""
    N, M, A, R = arr2.shape
    used = ~torch.isinf(t_on)
    comp = _seq_sum(torch.where(
        used, cost_per_sec[:, None, None, :]
        * (lease - torch.where(used, t_on, 0.0)), 0.0))
    rv = req_valid.reshape(N, M, 1, A * R)
    lat = torch.where(rv, appc - arr2.reshape(N, M, 1, A * R), 0.0)
    dl = deadline.repeat_interleave(R, -1)[:, None, None, :]
    misses = _seq_sum((rv & (lat > dl)).to(torch.float32))
    n_req = rv.to(torch.float32).sum(-1).clamp_min(1.0)
    if latency is not None:
        latency.copy_(lat.reshape(latency.shape))
    return comp + trans, misses / n_req, _seq_sum(lat), latency


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

    total, miss, lat_sum, latency = _epilogue(
        lease[..., :S], t_on[..., :S], appc[..., :A * R], trans,
        cost_per_sec, deadline, arr2, req_valid, latency)
    return total, miss, lat_sum, ph.pin_ok & ~ph.bad, latency


def traffic_step_tables(order: torch.Tensor, parent_idx: torch.Tensor,
                        app_id: torch.Tensor, slot_m: torch.Tensor,
                        n_valid: torch.Tensor, R: int, *, ring: int = RING,
                        tile: int = TILE) -> torch.Tensor:
    """What the kernel's walk shares across the particles of each (problem,
    draw) lane, per merged step: ``(N, M, T_pad, 2 + max_in)`` int32, the
    step axis ``T = R * max_p`` padded with no-op steps to a multiple of
    ``tile``. Entry 0 packs bit 0 "a real step" (one of the first
    ``n_valid``), bit 1 "its end is read more than ``ring`` steps later"
    and, from bit 8, the completion column ``app * R + r`` of the step's
    (app, request); on a tile's first step also bit 2 "some step of this
    tile reads a parent more than ``ring`` steps back" and bit 3 "every
    step of this tile is real". Entry 1 is the topo position of the step's
    layer (the plane row the walk reads; 0 on a no-op step). Entries 2..
    hold each parent slot's distance in merged steps: the step minus the
    step of the same request's parent layer; 0 for no parent, and -1 for a
    parent whose step has not come in this draw (an edge between apps whose
    requests arrive apart): its end reads 0, as the plain version's end
    buffer holds it until that step."""
    N, max_p = order.shape
    M, T = slot_m.shape[1:]
    if T != R * max_p:
        raise ValueError(f"slot_m has {T} steps a draw; {R} requests of "
                         f"{max_p} layers make {R * max_p}")
    max_in = parent_idx.shape[-1]
    dev = order.device
    i64 = torch.long
    t = torch.arange(T, device=dev)
    real = t < n_valid.to(i64)[..., None]                    # (N, M, T)
    slot = torch.where(real, slot_m.to(i64), 0)
    r = slot // max_p
    j = slot - r * max_p

    def by_layer(table, idx):                    # (N, K) at (N, M, T) ids
        return table.gather(1, idx.reshape(N, -1)).reshape(idx.shape)

    valid = order >= 0
    pos = torch.zeros((N, max_p + 1), dtype=i64, device=dev).scatter_(
        1, torch.where(valid, order.to(i64), max_p),
        torch.arange(max_p, device=dev).expand(N, max_p))
    q = torch.where(real, by_layer(pos, j), 0)
    c = by_layer(app_id.to(i64), j) * R + r
    # the merged step of every slot of the lane (-1: not a real step)
    at = torch.full((N, M, T + 1), -1, dtype=i64, device=dev).scatter_(
        2, torch.where(real, slot, T), t.expand(N, M, T))
    pars = parent_idx.to(i64).gather(1, j.reshape(N, -1, 1).expand(
        -1, -1, max_in)).reshape(N, M, T, max_in)
    pm = (pars >= 0) & real[..., None]
    ppos = at.gather(2, torch.where(pm, r[..., None] * max_p + pars,
                                    T).reshape(N, M, -1)).reshape(pars.shape)
    before = (ppos >= 0) & (ppos < t[:, None])
    dist = torch.where(pm, torch.where(before, t[:, None] - ppos, -1), 0)
    far = dist > ring
    far_write = torch.zeros((N, M, T + 1), dtype=i64, device=dev).scatter_(
        2, torch.where(far, ppos, T).reshape(N, M, -1), 1)[..., :T]
    head = torch.where(real, 1 | (far_write << 1) | (c << 8), 0)
    pad = -T % tile
    tiles = F.pad(torch.stack([far.any(-1), real], -1),
                  (0, 0, 0, pad)).reshape(N, M, -1, tile, 2)
    first = ((tiles[..., 0].any(-1).to(i64) << 2)
             | (tiles[..., 1].all(-1).to(i64) << 3))          # (N, M, tiles)
    meta = F.pad(torch.cat([head[..., None], q[..., None], dist], -1),
                 (0, 0, 0, pad))
    meta[:, :, ::tile, 0] |= first
    return meta.to(torch.int32).contiguous()


def traffic_ring_plain(order, compute, parent_idx, parent_mb, child_idx,
                       child_mb, app_id, deadline, pinned, power,
                       cost_per_sec, inv_bw, tran_cost, link_ok, X, slot_m,
                       arr_m, n_valid, arr2, req_valid, *,
                       faithful: bool = True,
                       latency: Optional[torch.Tensor] = None,
                       ring: int = RING, tile: int = TILE, ahead: int = AHEAD):
    """The kernel's walk in plain PyTorch, to test its addressing on the
    CPU with any ``ring``, ``tile`` and copy distance ``ahead`` (``ring >=
    (ahead + 1) tile``, as the kernel requires): the carry-free ``phase1``
    planes by topo position, read at each merged step's row ``q`` of the
    ``traffic_step_tables``, and a loop over tiles of steps that reads each
    parent's end from the previous step's end (distance 1), a ring of the
    last ``ring`` ends or, beyond it, from a buffer copied ``ahead`` tiles
    early out of the ends that ``far_write`` steps store. Ends not yet
    stored read as NaN, so a copy made before its value is final shows in
    the result. Same arguments and outputs as ``traffic_replay_plain``."""
    if ring < (ahead + 1) * tile:
        raise ValueError(f"ring {ring} must hold {ahead + 1} tiles of "
                         f"{tile} steps")
    X = X.to(torch.int32)
    N, P, max_p = X.shape
    M = _draws(slot_m)
    A, R = arr2.shape[-2:]
    S = power.shape[-1]
    max_in = parent_idx.shape[-1]
    dev = X.device
    valid = order >= 0
    ph = phase1(torch.where(valid, order, 0).long(), valid, compute,
                parent_idx, parent_mb, child_idx, child_mb, pinned, power,
                inv_bw, tran_cost, link_ok, X)
    meta = traffic_step_tables(order, parent_idx, app_id, slot_m, n_valid, R,
                               ring=ring, tile=tile)
    head, dist = meta[..., 0], meta[..., 2:].long()
    live, far_write = (head & 1) > 0, (head & 2) > 0
    col, q = (head >> 8).long(), meta[..., 1].long()
    steps = meta.shape[2]
    arr = F.pad(arr_m, (0, steps - slot_m.shape[2]))

    def rows(plane):            # (N, P, max_p, ...) -> (N, M, P, steps, ...)
        extra = plane.shape[3:]
        idx = q[:, :, None, :].reshape(N, M, 1, steps, *(1,) * len(extra))
        return plane[:, None].expand(N, M, P, max_p, *extra).gather(
            3, idx.expand(N, M, P, steps, *extra))

    srv, exe, out_t, tstep, mx, tt = (rows(p) for p in (
        ph.srv, ph.exe, ph.out_t, ph.tstep, ph.max_trans, ph.tt))

    def lanecol(idx):                    # (N, M) -> (N, M, P, 1) gather index
        return idx[:, :, None, None].expand(N, M, P, 1)

    def fetch(k):                        # tile k's reads beyond the ring
        buf = torch.zeros((N, M, P, tile, max_in), device=dev)
        for tl in range(tile):
            t = k * tile + tl
            for kk in range(max_in):
                d = dist[:, :, t, kk]
                got = far_end.gather(3, lanecol((t - d).clamp(min=0)))[..., 0]
                buf[..., tl, kk] = torch.where((d > ring)[..., None], got, 0.0)
        return buf

    lease = torch.zeros((N, M, P, S), device=dev)
    t_on = torch.full((N, M, P, S), float("inf"), device=dev)
    appc = torch.zeros((N, M, P, A * R), device=dev)
    ends = torch.zeros((N, M, P, ring), device=dev)
    prev_end = torch.zeros((N, M, P, 1), device=dev)
    far_end = torch.full((N, M, P, steps), float("nan"), device=dev)
    far_buf = {}
    trans = torch.zeros((N, M, P), device=dev)
    ntiles = steps // tile
    for k in range(ntiles):
        if not faithful:             # tiles below ``ahead`` read nothing far
            for kt in (range(ahead + 1) if k == 0 else (k + ahead,)):
                if kt < ntiles:
                    far_buf[kt] = fetch(kt)
        for tl in range(tile):
            t = k * tile + tl
            v = live[:, :, t, None, None]
            s_t = srv[..., t, None]
            exe_t, out_tt = exe[..., t, None], out_t[..., t, None]
            a = arr[:, :, t, None, None]
            lease_srv = lease.gather(3, s_t)
            if faithful:
                b = torch.maximum(lease_srv, a)
                start = b + mx[..., t, None]
                new_lease = (b + exe_t) + out_tt
            else:
                gate = torch.zeros((N, M, P, 1), device=dev)
                for kk in range(max_in):
                    d = dist[:, :, t, kk][..., None, None]
                    e = torch.where(
                        d == 1, prev_end, torch.where(
                            d <= ring,
                            ends.gather(3, lanecol((t - dist[:, :, t, kk])
                                                   % ring)),
                            far_buf[k][..., tl, kk, None]))
                    e = torch.where(d < 0, 0.0, e)
                    gate = torch.where(d > 0, torch.maximum(
                        gate, e + tt[..., t, kk, None]), gate)
                start = torch.maximum(lease_srv, torch.maximum(gate, a))
                new_lease = (start + exe_t) + out_tt
            t_end = start + exe_t
            lease.scatter_(3, s_t, torch.where(v, new_lease, lease_srv))
            on = t_on.gather(3, s_t)
            t_on.scatter_(3, s_t, torch.where(v, torch.minimum(on, start), on))
            c_t = lanecol(col[:, :, t])
            ac = appc.gather(3, c_t)
            appc.scatter_(3, c_t, torch.where(v, torch.maximum(ac, t_end), ac))
            if not faithful:
                e_t, v_t = t_end[..., 0], v[..., 0]
                ends[..., t % ring] = torch.where(v_t, e_t, ends[..., t % ring])
                far_end[..., t] = torch.where(
                    v_t & far_write[:, :, t, None], e_t, far_end[..., t])
                prev_end = torch.where(v, t_end, prev_end)
            trans = torch.where(v[..., 0], trans + tstep[..., t], trans)
    total, miss, lat_sum, latency = _epilogue(
        lease, t_on, appc, trans, cost_per_sec, deadline, arr2, req_valid,
        latency)
    return total, miss, lat_sum, ph.pin_ok & ~ph.bad, latency


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


def _tables(order, parent_idx, app_id, slot_m, n_valid, R):
    """``traffic_step_tables`` for the kernel, computed once per merged
    order (a solve builds its ``TrafficInputs`` once)."""
    return _memo_tables(
        "traffic", (order, parent_idx, app_id, slot_m, n_valid),
        lambda: traffic_step_tables(order, parent_idx, app_id, slot_m,
                                    n_valid, R))


def _lib():
    global _LIB
    with LOCK:
        if _LIB is None:
            from ._build import load
            lib = load("traffic_sim")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.traffic_replay_launch.argtypes = [vp] * 27 + [ci] * 12 + [vp]
            lib.traffic_replay_launch.restype = ci
            lib.traffic_replay_smem_bytes.argtypes = [ci] * 5
            lib.traffic_replay_smem_bytes.restype = ctypes.c_size_t
            lib.traffic_replay_fields.argtypes = [ci, ci]
            lib.traffic_replay_error_string.argtypes = [ci]
            lib.traffic_replay_error_string.restype = ctypes.c_char_p
            geometry = (lib.traffic_replay_ring(), lib.traffic_replay_tile(),
                        lib.traffic_replay_ahead())
            if geometry != (RING, TILE, AHEAD):
                raise RuntimeError(f"traffic_sim.cu walks a ring, tile and "
                                   f"copy distance of {geometry}, the "
                                   f"wrapper expects {(RING, TILE, AHEAD)}")
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
    if max_in > MAX_IN:
        raise ValueError(f"{max_in} parent slots; the kernel takes at most "
                         f"{MAX_IN}")
    lib = _lib()
    smem = lib.traffic_replay_smem_bytes(S, A, R, max_in, int(faithful))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{S} servers, {A} apps x {R} requests and {max_in} "
                         f"parent slots need {smem} bytes of shared memory; "
                         f"a block has {MAX_SMEM_BYTES}")
    meta = _tables(order, parent_idx, app_id, slot_m, n_valid, R)
    T_pad = meta.shape[2]
    P_pad = -(-P // 32) * 32             # whole warps: 128-byte plane rows
    n_chunks = -(-max_p // lib.traffic_replay_chunk())
    planes = torch.empty((N, lib.traffic_replay_fields(max_in, int(faithful)),
                          max_p, P_pad), dtype=f32, device=dev)
    flags = torch.empty((N, n_chunks, P_pad), dtype=torch.uint8, device=dev)
    far_end = torch.empty((1,) if faithful else (N, M, T_pad, P_pad),
                          dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (
        X, order, compute, parent_idx, parent_mb, child_idx, child_mb,
        deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
        link_ok.view(torch.uint8), meta, arr_m, n_valid, arr2,
        req_valid.view(torch.uint8), planes, flags, far_end, total, miss,
        lat_sum, static_ok.view(torch.uint8))]
    ptrs.append(None if latency is None else latency.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with LOCK:
        traffic_replay.launches += 1
    err = lib.traffic_replay_launch(
        *ptrs, N, M, P, P_pad, max_p, T_pad, max_in, max_out, S, A, R,
        int(faithful), stream)
    if err != 0:
        raise RuntimeError(
            "traffic_replay kernel launch failed: "
            f"{lib.traffic_replay_error_string(err).decode()}")
    return total, miss, lat_sum, static_ok, latency
