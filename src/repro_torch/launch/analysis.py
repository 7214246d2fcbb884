"""Roofline analysis of one step: the port of ``repro/launch/analysis.py``,
and the counter that gives it its inputs.

The card is the target. The three roofline terms of a (arch x shape x
mesh) cell come from the dry run's trace of one rank's step
(``launch.dryrun``):

    compute    = FLOPs_per_chip / PEAK_FLOPS              [s]
    memory     = bytes_per_chip / HBM_BW                  [s]
    collective = collective_bytes_per_chip / ICI_BW       [s]

``collective_bytes`` sums, for every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute, the bytes that cross
links *per device*:

    all-gather      (group-1)/group x result bytes   (receives all shards)
    all-reduce      2 x (group-1)/group x bytes      (ring RS + AG)
    reduce-scatter  (group-1)/group x input bytes
    all-to-all      (group-1)/group x bytes
    collective-permute  result bytes

It reads the reference's input, a partitioned HLO module's text (group
sizes from both replica_groups formats, ``{{0,1},...}`` and the iota
``[G,S]<=[N]`` form), or the port's: the ``core.collectives.Collective``
records of a traced step, each with its group's exact ranks. On the
multi-pod mesh a group that spans pods is priced at DCN bandwidth (the
"pod" axis rides the data-center network, not NVLink); a record crosses
when its ranks fall in more than one pod, the reference's rule for an
explicit group list.

``trace_step`` counts a step as it runs, on ``meta``, ``cpu`` or
``cuda`` alike: matmul FLOPs (``torch.utils.flop_counter``'s formulas)
plus each hand-written kernel's analytic ``cost``, the bytes every
operator reads and writes, the live storages' high-water mark, the
collectives and the kernel calls (``StepCost``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterable, List, Tuple, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core.collectives import Collective, record_collectives
from ..kernels import _trace

__all__ = ["HW", "collective_bytes", "CollectiveStats", "roofline_terms",
           "parse_hlo_collectives", "StepCost", "trace_step"]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 80GB HBM3 (SXM, 700 W), per card, from its data sheet;
    the links of a fleet of 8-GPU nodes."""
    peak_flops: float = 989e12        # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12           # B/s
    ici_bw: float = 450e9             # B/s a direction: NVLink 4
    dcn_bw: float = 50e9              # B/s: one 400 Gb/s NIC a GPU
    hbm_bytes: float = 80e9


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:\w+\[[\d,]*\]\S*))\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_GROUPS_ITOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(text: str) -> int:
    """Sum bytes over every shape token in a result (handles tuples)."""
    total = 0
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, float]
    total_ici: float                  # per-device bytes over NVLink
    total_dcn: float                  # per-device bytes over DCN
    count: int

    @property
    def total(self) -> float:
        return self.total_ici + self.total_dcn


def parse_hlo_collectives(hlo: str) -> List[Tuple[str, int, int, str]]:
    """Returns [(op, result_bytes, group_size, line)] for each collective."""
    out = []
    for line in hlo.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        res_bytes = _shape_bytes(m.group(1))
        op = m.group(2)
        group = 1
        gi = _GROUPS_ITOTA_RE.search(line)
        if gi:
            group = int(gi.group(2))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            if gl:
                group = len([x for x in gl.group(1).split(",") if x.strip()])
        out.append((op, res_bytes, group, line))
    return out


def collective_bytes(hlo: Union[str, Iterable[Collective]],
                     pod_size: int = 0) -> CollectiveStats:
    """Per-device link bytes of an HLO module's text or of a traced step's
    ``Collective`` records. ``pod_size``: devices per pod (0 = single
    pod); a group crossing a pod boundary is priced as DCN."""
    per_op: Dict[str, float] = {}
    ici = dcn = 0.0
    if isinstance(hlo, str):
        ops = parse_hlo_collectives(hlo)
    else:
        ops = [(c.op, c.result_bytes, len(c.ranks), tuple(c.ranks))
               for c in hlo]
    for op, res_bytes, group, where in ops:
        g = max(group, 1)
        frac = (g - 1) / g
        if op == "all-gather":
            b = frac * res_bytes
        elif op == "all-reduce":
            b = 2.0 * frac * res_bytes
        elif op == "reduce-scatter":
            b = frac * res_bytes * g          # input volume per device
        elif op == "all-to-all":
            b = frac * res_bytes
        else:                                  # collective-permute
            b = float(res_bytes)
        per_op[op] = per_op.get(op, 0.0) + b
        crosses_pod = bool(pod_size) and (
            _group_crosses_pod(where, g, pod_size) if isinstance(where, str)
            else _ranks_cross_pod(where, pod_size))
        if crosses_pod:
            dcn += b
        else:
            ici += b
    return CollectiveStats(per_op=per_op, total_ici=ici, total_dcn=dcn,
                           count=len(ops))


def _ranks_cross_pod(ids: Tuple[int, ...], pod_size: int) -> bool:
    """A group given by its ranks crosses pods when its lowest and highest
    rank lie in different pods (the explicit-list rule below)."""
    if not ids:
        return False
    return (max(ids) // pod_size) != (min(ids) // pod_size)


def _group_crosses_pod(line: str, group: int, pod_size: int) -> bool:
    """Heuristic pod-crossing test.

    Explicit lists: check ids of the first group straddle a pod boundary.
    Iota form [G,S]<=[dims]T(perm): a group crosses pods iff the iota
    device order interleaves pods within a group — detectable from the
    fastest-varying transposed dims; we conservatively flag any group
    whose SPAN (max-min of the first explicit group) >= pod_size, and for
    iota forms flag when group*stride patterns must include both pods
    (group size > pod_size, or the leading reshape dim participates).
    """
    gl = _GROUPS_LIST_RE.search(line)
    if gl:
        ids = [int(x) for x in gl.group(1).split(",") if x.strip()]
        return _ranks_cross_pod(tuple(ids), pod_size)
    gi = _GROUPS_ITOTA_RE.search(line)
    if gi:
        n_total = 1
        for d in gi.group(3).split(","):
            n_total *= int(d)
        if n_total <= pod_size:
            return False
        if group > pod_size:
            return True
        # iota groups of size S are consecutive in the (possibly
        # transposed) device order; with a transpose the stride across the
        # leading (pod) dim lands inside groups. Conservative: transposed
        # iota on a >1-pod fleet crosses pods unless the group fits the
        # innermost contiguous run.
        return "T(" in line
    return False


def roofline_terms(flops_per_chip: float, hbm_bytes_per_chip: float,
                   coll: CollectiveStats, hw: HW = HW()) -> Dict[str, float]:
    compute = flops_per_chip / hw.peak_flops
    memory = hbm_bytes_per_chip / hw.hbm_bw
    collective = coll.total_ici / hw.ici_bw + coll.total_dcn / hw.dcn_bw
    dominant = max((("compute", compute), ("memory", memory),
                    ("collective", collective)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant}


# ---------------------------------------------------------------------------
# the step counter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCost:
    """What ``trace_step`` counted over one step.

    ``flops`` = ``matmul_flops`` (every operator ``torch.utils.
    flop_counter`` has a formula for: mm, bmm, addmm, baddbmm,
    convolutions) + ``kernel_flops`` (each kernel call's analytic cost);
    elementwise operators count none. ``bytes`` = the tensors every other
    operator reads and writes (views and allocations move none)
    + ``kernel_bytes``. Memory, from the storages alive at each
    operator's end: ``argument_bytes`` (the arguments and the ``live``
    tensors), ``output_bytes`` (the storages the result holds),
    ``alias_bytes`` (those of them that are arguments: caches and state
    updated in place), ``peak_bytes`` (the arguments plus the largest sum
    of other live storages) and ``temp_bytes`` (``peak - argument -
    output + alias``, the reference's identity). ``collectives``: the
    step's ``Collective`` records in issue order; ``kernel_calls``:
    ``{"name", "flops", "bytes", "out_bytes"}`` (and any further terms of
    the kernel's ``cost``) per call; ``ops``: operators counted;
    ``peak_by_op``: the live storages besides the arguments at the peak,
    in bytes by the operator (or kernel) and dtype that made them."""
    flops: int = 0
    matmul_flops: int = 0
    kernel_flops: int = 0
    bytes: int = 0
    kernel_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0
    collectives: List[Collective] = dataclasses.field(default_factory=list)
    kernel_calls: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    peak_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)

    def counts(self) -> Dict[str, Any]:
        """The device-independent part: what a ``meta`` trace must equal
        a real one in."""
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes,
                "collectives": [tuple(c) for c in self.collectives],
                "kernel_calls": self.kernel_calls}

    def kernels_by_name(self) -> Dict[str, Dict[str, int]]:
        """Calls, FLOPs and bytes summed by kernel."""
        out: Dict[str, Dict[str, int]] = {}
        for c in self.kernel_calls:
            s = out.setdefault(c["name"], {"calls": 0, "flops": 0,
                                           "bytes": 0})
            s["calls"] += 1
            s["flops"] += c["flops"]
            s["bytes"] += c["bytes"]
        return out


#: operators that move no data: allocations, and a reshape's view
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten._unsafe_view.default,
}
#: the lift of a tensor made from Python data, which is made unseen on
#: the CPU and on the card but not on ``meta``: passed through uncounted
_LIFT = torch.ops.aten.lift_fresh.default


def _tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor in ``x``: nested dicts and sequences (named tuples
    too)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """The dispatch mode behind ``trace_step``."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self.hidden = 0
        self.args: Dict[int, int] = {}        # storage key -> bytes
        self.temps: Dict[int, Tuple[StorageWeakRef, int, str]] = {}
        self.live = 0                         # bytes of self.temps, or more
        self.by_op: Dict[str, int] = {}       # self.temps' bytes by maker

    @staticmethod
    def _key(t: torch.Tensor):
        s = t.untyped_storage()
        return StorageWeakRef(s), s.nbytes()

    def hold_args(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            ref, n = self._key(t)
            self.args.setdefault(ref.cdata, n)
        self.cost.argument_bytes = sum(self.args.values())
        self.cost.peak_bytes = self.cost.argument_bytes

    def _allocated(self, tensors: Iterable[torch.Tensor], maker: str,
                   nbytes=None) -> None:
        """Note new storages among ``tensors``, made by ``maker``
        (``nbytes``: count each as its tensor's bytes, a kernel's
        allocation), and the peak."""
        grew = False
        for t in tensors:
            ref, n = self._key(t)
            k = ref.cdata
            if k in self.args:
                continue
            old = self.temps.get(k)
            if old is not None:
                if not old[0].expired():
                    continue
                self._forget(k)
            n = nbytes(t) if nbytes else n
            label = f"{maker} {str(t.dtype)[6:]}"
            self.temps[k] = (ref, n, label)
            self.live += n
            self.by_op[label] = self.by_op.get(label, 0) + n
            grew = True
        if grew and self.cost.argument_bytes + self.live \
                > self.cost.peak_bytes:
            self._settle()

    def _forget(self, k: int) -> None:
        _, n, label = self.temps.pop(k)
        self.live -= n
        self.by_op[label] -= n

    def _settle(self) -> None:
        """Forget freed storages; raise the peak to what is live."""
        for k in [k for k, v in self.temps.items() if v[0].expired()]:
            self._forget(k)
        if self.cost.argument_bytes + self.live > self.cost.peak_bytes:
            self.cost.peak_bytes = self.cost.argument_bytes + self.live
            self.cost.peak_by_op = {k: n for k, n in self.by_op.items()
                                    if n}

    def kernel(self, name, run, cost, args, kwargs):
        work = dict(cost(*args, **kwargs))
        self.hidden += 1
        try:
            out = run(*args, **kwargs)
        finally:
            self.hidden -= 1
        outs = _tensors(out, [])
        work = {"name": name, **work,
                "out_bytes": sum(_nbytes(t) for t in outs)}
        self.cost.kernel_calls.append(work)
        self.cost.kernel_flops += work["flops"]
        self.cost.kernel_bytes += work["bytes"]
        self._allocated(outs, name, _nbytes)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.hidden or func is _LIFT:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func.namespace == "aten" \
                and not func.is_view:
            with self:                               # into counted parts
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.cost.ops += 1
        if packet in flop_registry:
            self.cost.matmul_flops += int(flop_registry[packet](
                *args, **kwargs, out_val=out))
        outs = _tensors(out, [])
        if func.namespace == "aten" and not func.is_view \
                and func not in _NO_TRAFFIC:
            self.cost.bytes += sum(_nbytes(t) for t in _tensors(
                (args, kwargs), outs[:]))
        self._allocated(outs, packet.__name__)
        return out


def trace_step(fn, *args, live: Iterable[torch.Tensor] = (), **kwargs
               ) -> Tuple[Any, StepCost]:
    """Run ``fn(*args, **kwargs)`` once and count it (``StepCost``):
    ``live`` are tensors the step reads besides its arguments (a model's
    parameters and buffers), held like them. Returns ``(fn's result,
    cost)``. The counts depend on the shapes, dtypes and code path only,
    so a step on ``meta`` counts as the same step on the CPU or the
    card."""
    if _trace.TRACER is not None:
        raise RuntimeError("trace_step does not nest")
    counter = _Counter()
    counter.hold_args(_tensors((args, kwargs), list(live)))
    with record_collectives() as recs:
        _trace.TRACER = counter
        try:
            with counter:
                out = fn(*args, **kwargs)
        finally:
            _trace.TRACER = None
    c = counter.cost
    c.collectives = list(recs)
    counter._allocated(_tensors(out, []), "step")
    counter._settle()
    seen = set()
    for t in _tensors(out, []):
        ref, n = counter._key(t)
        if ref.cdata in seen:
            continue
        seen.add(ref.cdata)
        if ref.cdata in counter.args:
            c.alias_bytes += n
            c.output_bytes += n
        else:
            c.output_bytes += counter.temps[ref.cdata][1]
    c.flops = c.matmul_flops + c.kernel_flops
    c.bytes += c.kernel_bytes
    c.temp_bytes = c.peak_bytes - c.argument_bytes - c.output_bytes \
        + c.alias_bytes
    return out, c
