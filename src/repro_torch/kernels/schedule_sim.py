"""Algorithm-2 swarm replay: the CUDA kernel's wrapper and its plain
PyTorch version.

The PSO-GA fitness hot path scores every particle (server-assignment
vector) of a swarm against a padded problem once per iteration. The
hand-written Hopper kernel (``csrc/schedule_sim.cu``, the port of the
Pallas kernel ``repro/kernels/schedule_sim.py::_schedule_kernel``) makes
two CUDA launches per call: a carry-free pass over every (step, particle)
(``phase1`` below), then a walk that carries only the server leases and,
in corrected mode, a ring of the last ``RING`` end times per particle.
``step_tables`` builds what the walk shares across particles: each step's
app, each parent's step distance and which ends are read beyond the
ring. ``schedule_replay_plain`` is the same arithmetic as a plain PyTorch
loop over layers with the particle axis inside each op, used on the CPU
and to check the kernel on the card; ``replay_ring_plain`` runs the
walk's ring and far-read addressing in plain PyTorch, with any ring, tile
and copy distance, for the CPU tests.

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
``launches`` attribute counts calls that launch the kernel (each is one
replay of the swarm, two CUDA launches).

Every float sum in the plain version runs in the kernel's order (over
steps, then parents or children, then servers, then apps), so padded
entries, appended after the real ones, add exact zeros: results are
invariant under any legal padding, and the kernel (built with
``--fmad=false``) computes the same roundings.
"""
from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import NamedTuple, Tuple

import torch

__all__ = ["schedule_replay", "schedule_replay_plain", "replay_plain",
           "replay_ring_plain", "step_tables", "ReplayState", "Phase1",
           "phase1", "MAX_SMEM_BYTES", "RING", "TILE", "AHEAD"]

#: dynamic shared memory one H100 block can opt in to (227 KB)
MAX_SMEM_BYTES = 232_448
#: the walk's ring of end times, its tile of steps, and how many tiles
#: ahead it copies (``csrc`` kW, kT, kAhead)
RING, TILE, AHEAD = 64, 16, 3
#: the most parent slots a step may have on the kernel route (``csrc`` kMaxIn)
MAX_IN = 8


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


def step_tables(order: torch.Tensor, parent_idx: torch.Tensor,
                app_id: torch.Tensor, *, ring: int = RING, tile: int = TILE
                ) -> torch.Tensor:
    """What the kernel's walk shares across particles, per step:
    ``(N, max_p_pad, 1 + max_in)`` int32, the step axis padded with
    no-op steps to a multiple of ``tile``. Entry 0 packs bit 0 "a real
    step", bit 1 "its end is read more than ``ring`` steps later" and the
    step's app id from bit 8; on a tile's first step also bit 2 "some step
    of this tile reads a parent more than ``ring`` steps back" and bit 3
    "every step of this tile is real". Entries 1.. hold each parent slot's
    step distance (0 for no parent)."""
    N, max_p = order.shape
    max_in = parent_idx.shape[-1]
    dev = order.device
    valid = order >= 0
    jsafe = torch.where(valid, order, 0).long()
    t = torch.arange(max_p, device=dev)
    pos = torch.zeros((N, max_p + 1), dtype=torch.long, device=dev).scatter_(
        1, torch.where(valid, order.long(), max_p), t.expand(N, max_p))
    pars = parent_idx.long().gather(1, jsafe[..., None].expand(N, max_p,
                                                               max_in))
    pm = (pars >= 0) & valid[..., None]
    ppos = pos.gather(1, torch.where(pm, pars, max_p).reshape(N, -1)
                      ).reshape(N, max_p, max_in)
    dist = torch.where(pm, t[None, :, None] - ppos, 0)
    far = dist > ring
    far_write = torch.zeros((N, max_p + 1), dtype=torch.long,
                            device=dev).scatter_(
        1, torch.where(far, ppos, max_p).reshape(N, -1), 1)[:, :max_p]
    app = app_id.long().gather(1, jsafe)
    head = torch.where(valid, 1 | (far_write << 1) | (app << 8), 0)
    pad = -max_p % tile
    tiles = torch.nn.functional.pad(torch.stack(
        [far.any(-1), valid], -1), (0, 0, 0, pad)).reshape(N, -1, tile, 2)
    first = ((tiles[..., 0].any(-1).long() << 2)
             | (tiles[..., 1].all(-1).long() << 3))          # (N, tiles)
    meta = torch.nn.functional.pad(
        torch.cat([head[..., None], dist], -1), (0, 0, 0, pad))
    meta[:, ::tile, 0] |= first
    return meta.to(torch.int32).contiguous()


def replay_ring_plain(order, compute, parent_idx, parent_mb, child_idx,
                      child_mb, app_id, deadline, pinned, power,
                      cost_per_sec, inv_bw, tran_cost, link_ok, X, *,
                      faithful: bool = True, ring: int = RING,
                      tile: int = TILE, ahead: int = AHEAD
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's walk in plain PyTorch, to test its addressing on the
    CPU with any ``ring``, ``tile`` and copy distance ``ahead`` (``ring >=
    (ahead + 1) tile``, as the kernel requires): the carry-free ``phase1``
    planes, the ``step_tables``, and a loop over tiles of steps that reads
    each parent's end from the previous step's end (distance 1), a ring of
    the last ``ring`` ends or, beyond it, from a buffer copied ``ahead``
    tiles early out of the ends that ``far_write`` steps store. Ends not
    yet stored read as NaN, so a copy made before its value is final shows
    in the result. Same outputs as ``schedule_replay_plain``."""
    if ring < (ahead + 1) * tile:
        raise ValueError(f"ring {ring} must hold {ahead + 1} tiles of "
                         f"{tile} steps")
    X = X.to(torch.int32)
    N, P, max_p = X.shape
    S = power.shape[-1]
    max_in = parent_idx.shape[-1]
    max_apps = deadline.shape[-1]
    dev = X.device
    valid = order >= 0
    ph = phase1(torch.where(valid, order, 0).long(), valid, compute,
                parent_idx, parent_mb, child_idx, child_mb, pinned, power,
                inv_bw, tran_cost, link_ok, X)
    meta = step_tables(order, parent_idx, app_id, ring=ring, tile=tile)
    head, dist = meta[..., 0], meta[..., 1:].long()
    live, far_write, app = (head & 1) > 0, (head & 2) > 0, (head >> 8).long()
    steps = meta.shape[1]

    def col(idx):                         # (N,) -> (N, P, 1) gather index
        return idx[:, None, None].expand(N, P, 1)

    def fetch(k):                         # tile k's reads beyond the ring
        buf = torch.zeros((N, P, tile, max_in), device=dev)
        for tl in range(tile):
            t = k * tile + tl
            for kk in range(max_in):
                d = dist[:, t, kk]
                got = far_end.gather(2, col((t - d).clamp(min=0)))[..., 0]
                buf[:, :, tl, kk] = torch.where((d > ring)[:, None], got, 0.0)
        return buf

    lease = torch.zeros((N, P, S), device=dev)
    t_on = torch.full((N, P, S), float("inf"), device=dev)
    appc = torch.zeros((N, P, max_apps), device=dev)
    ends = torch.zeros((N, P, ring), device=dev)
    prev_end = torch.zeros((N, P, 1), device=dev)
    far_end = torch.full((N, P, steps), float("nan"), device=dev)
    far_buf = {}
    trans = torch.zeros((N, P), device=dev)
    for k in range(steps // tile):
        if k == 0 and not faithful:
            for j in range(min(ahead, steps // tile)):
                far_buf[j] = fetch(j)
        if not faithful and (k + ahead) * tile < steps:
            far_buf[k + ahead] = fetch(k + ahead)
        for tl in range(min(tile, max_p - k * tile)):
            t = k * tile + tl
            v = live[:, t, None, None]
            s_t = ph.srv[:, :, t, None]
            exe = ph.exe[:, :, t, None]
            out_t = ph.out_t[:, :, t, None]
            lease_srv = lease.gather(2, s_t)
            if faithful:
                start = lease_srv + ph.max_trans[:, :, t, None]
                new_lease = (lease_srv + exe) + out_t
            else:
                gate = torch.zeros((N, P, 1), device=dev)
                for kk in range(max_in):
                    d = dist[:, t, kk][:, None, None]
                    e = torch.where(
                        d == 1, prev_end, torch.where(
                            d <= ring,
                            ends.gather(2, col((t - dist[:, t, kk]) % ring)),
                            far_buf[k][:, :, tl, kk, None]))
                    gate = torch.where(d > 0, torch.maximum(
                        gate, e + ph.tt[:, :, t, kk, None]), gate)
                start = torch.maximum(lease_srv, gate)
                new_lease = (start + exe) + out_t
            t_end = start + exe
            lease.scatter_(2, s_t, torch.where(v, new_lease, lease_srv))
            on = t_on.gather(2, s_t)
            t_on.scatter_(2, s_t, torch.where(v, torch.minimum(on, start), on))
            a_t = col(app[:, t])
            ac = appc.gather(2, a_t)
            appc.scatter_(2, a_t, torch.where(v, torch.maximum(ac, t_end), ac))
            if not faithful:
                e_t = t_end[..., 0]
                ends[:, :, t % ring] = torch.where(v[..., 0], e_t,
                                                   ends[:, :, t % ring])
                far_end[:, :, t] = torch.where(
                    v[..., 0] & far_write[:, t, None], e_t, far_end[:, :, t])
                prev_end = torch.where(v, t_end, prev_end)
            trans = torch.where(v[..., 0], trans + ph.tstep[:, :, t], trans)
    used = ~torch.isinf(t_on)
    comp = _seq_sum(torch.where(
        used, cost_per_sec[:, None, :] * (lease - torch.where(used, t_on, 0.0)),
        0.0))
    feasible = (appc <= deadline[:, None, :]).all(-1) & ph.pin_ok & ~ph.bad
    return comp + trans, feasible, _seq_sum(appc)


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
#: step tables of the problems (and merged orders) replayed lately, with the
#: tensors they came from (held, so their memory is not reused while cached)
#: and their version counters (an in-place change misses)
_TABLES: "OrderedDict[tuple, tuple]" = OrderedDict()
_TABLES_KEPT = 16
#: guards ``_TABLES``, both libraries' first load and both launch counters:
#: ``core.service.run_services`` replays from several threads at once
LOCK = threading.RLock()


def _memo_tables(tag: str, srcs, build):
    """``build()``, computed once per ``tag`` and set of source tensors
    ``srcs`` (kept for the last ``_TABLES_KEPT`` of them). Thread-safe:
    two threads that miss on one key may both build it, and either result
    is the same tables."""
    key = (tag,) + tuple((t.data_ptr(), tuple(t.shape), t.stride(),
                          str(t.device)) for t in srcs)
    versions = tuple(t._version for t in srcs)
    with LOCK:
        hit = _TABLES.get(key)
        if hit is not None and hit[1] == versions:
            _TABLES.move_to_end(key)
            return hit[2]
    meta = build()
    with LOCK:
        _TABLES[key] = (srcs, versions, meta)
        _TABLES.move_to_end(key)
        while len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    return meta


def _tables(order, parent_idx, app_id):
    """``step_tables`` for the kernel, computed once per problem."""
    return _memo_tables("schedule", (order, parent_idx, app_id),
                        lambda: step_tables(order, parent_idx, app_id))


def _lib():
    global _LIB
    with LOCK:
        if _LIB is None:
            from ._build import load
            lib = load("schedule_sim")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.schedule_replay_launch.argtypes = \
                [vp] * 21 + [ci] * 10 + [vp]
            lib.schedule_replay_launch.restype = ci
            lib.schedule_replay_smem_bytes.argtypes = [ci] * 4
            lib.schedule_replay_smem_bytes.restype = ctypes.c_size_t
            lib.schedule_replay_fields.argtypes = [ci, ci]
            lib.schedule_replay_error_string.argtypes = [ci]
            lib.schedule_replay_error_string.restype = ctypes.c_char_p
            geometry = (lib.schedule_replay_ring(),
                        lib.schedule_replay_tile(),
                        lib.schedule_replay_ahead())
            if geometry != (RING, TILE, AHEAD):
                raise RuntimeError(f"schedule_sim.cu walks a ring, tile and "
                                   f"copy distance of {geometry}, the wrapper "
                                   f"expects {(RING, TILE, AHEAD)}")
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
    if max_in > MAX_IN:
        raise ValueError(f"{max_in} parent slots; the kernel takes at most "
                         f"{MAX_IN}")
    lib = _lib()
    smem = lib.schedule_replay_smem_bytes(S, max_apps, max_in, int(faithful))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{S} servers, {max_apps} apps and {max_in} parent "
                         f"slots need {smem} bytes of shared memory; a block "
                         f"has {MAX_SMEM_BYTES}")
    meta = _tables(order, parent_idx, app_id)
    max_p_pad = meta.shape[1]
    P_pad = -(-P // 32) * 32             # whole warps: 128-byte plane rows
    n_chunks = -(-max_p // lib.schedule_replay_chunk())
    planes = torch.empty((N, lib.schedule_replay_fields(max_in, int(faithful)),
                          max_p_pad, P_pad), dtype=f32, device=dev)
    flags = torch.empty((N, n_chunks, P_pad), dtype=torch.uint8, device=dev)
    far_end = torch.empty((1,) if faithful else (N, max_p_pad, P_pad),
                          dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (
        X, order, compute, parent_idx, parent_mb, child_idx, child_mb,
        deadline, pinned, power, cost_per_sec, inv_bw, tran_cost,
        link_ok.view(torch.uint8), meta, planes, flags, far_end, total, feas,
        tsum)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with LOCK:
        schedule_replay.launches += 1
    err = lib.schedule_replay_launch(
        *ptrs, N, P, P_pad, max_p, max_p_pad, max_in, max_out, S, max_apps,
        int(faithful), stream)
    if err != 0:
        raise RuntimeError(
            "schedule_replay kernel launch failed: "
            f"{lib.schedule_replay_error_string(err).decode()}")
    return total, feas, tsum
