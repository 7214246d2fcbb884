"""The program's own spans in a traced call, and device time attributed to
them by launch.

The port opens spans inside its serving path when a telemetry is installed
(``repro_torch.core.telemetry``): ``serve.generate``, ``serve.prefill``,
``serve.decode_step``, ``serve.readback`` (``launch/serve.py``),
``mamba.seq``, ``mamba.state``, ``mamba.store`` and ``ssd.chunked`` with its
phases ``ssd.intra`` (B5), ``ssd.outflow``, ``ssd.chunk_loop``,
``ssd.inflow`` (``models/ssm.py``, ``models/hybrid.py``). Each span is also a
``torch.profiler.record_function`` range, so under the profiler it sits in
the kineto trace on the device operations' clock.

A device operation belongs to the innermost program span that was open on
the host when it was launched, else to the innermost ``bench.*`` span: never
to a span chosen by its name. Its launch is the CUDA runtime call that
carries its correlation id (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ..);
where the trace has none, the host operation its linked correlation id
names. (A kernel launched through ``ctypes``, as B5 is, has no linked host
operation: only the runtime call places it.)

Here are the calls of a traced run and the helpers the readers of
``bench/metrics/`` use:

- ``spanned_call``: one call with the telemetry installed and no profiler;
  its spans on the host clock; with ``drain`` the device's queue is emptied
  before each block of a decode step, so that no launch waits for room in
  it and a step's host time is the host's own work;
- ``profiled_call``: one call under ``torch.profiler`` with the telemetry
  installed; the trace the harness's ``Bench.traced_call`` returns
  (``kernels``, ``spans``, ``window_s``, the same content), plus
  ``program_spans``, ``launched_at`` and ``launched_in``;
- ``device_ms_by_span``, ``idle_by_span``, ``launched_inside``,
  ``host_self_s``.

    python3 -m bench.spans --workload mamba2-2.7b.decode-b256 --seed 7 \\
        --seconds 30

runs a cell's set-up and window as ``bench/run.py --trace 1`` does, then one
call with the spans off, on, on and off, one drained and one profiled; it
prints the cell's per-layer metrics and those of ``SPAN_METRICS`` as one JSON
line, with the calls' times (the spans' cost), B5 found by name against B5 by
launch, device time and idle gaps by span. ``bench/harness.py`` does not call
this module yet: a ``--trace 1`` run of ``bench/run.py`` reports none of
``SPAN_METRICS``.
"""
from __future__ import annotations

import bisect
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import yardstick

__all__ = ["PROGRAM", "SPAN_METRICS", "is_program", "innermost", "convert",
           "host_spans", "spanned_call", "profiled_call", "launched_inside",
           "busy_ms", "device_ms_by_span", "idle_by_span", "host_self_s",
           "count"]

#: the prefixes of the program's span names (its contract)
PROGRAM = ("serve.", "mamba.", "ssd.")
#: the benchmark's span around each wait for an empty device queue in a
#: drained ``spanned_call``
DRAIN = "bench.drain"
#: the prefix of the CUDA API calls that launch device work
#: (``cudaLaunchKernel``, ``cuLaunchKernel``, ..): an operation's own launch
RUNTIME = "cu"
#: the metrics of ``bench/metrics/`` that read the program's spans
SPAN_METRICS = ("decode_busy_ms_per_step", "decode_host_ms_per_step",
                "decode_state_ms_per_step", "decode_ops_per_step",
                "prefill_ssd_ms", "prefill_block_ms")

Span = Tuple[str, float, float]


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def innermost(spans: Sequence[Span], times: Sequence[float]
              ) -> List[Optional[int]]:
    """For each of ``times``, the index in ``spans`` of the innermost span
    open then (start <= t <= end; of nested spans the one that started
    last), or None. Spans nest as the with-statements that opened them."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    j = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(order) and spans[order[j]][1] <= t:
            s = order[j]
            while stack and spans[stack[-1]][2] < spans[s][1]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def _attribute(program: Sequence[Span], bench: Sequence[Span],
               times: Sequence[float]) -> List[Optional[str]]:
    """The innermost program span open at each of ``times``, else the
    innermost ``bench.*`` span, by name (None outside both)."""
    p, b = innermost(program, times), innermost(bench, times)
    return [program[i][0] if i is not None else
            bench[k][0] if k is not None else None for i, k in zip(p, b)]


def convert(events) -> Dict:
    """The trace of one call from kineto's events (``kineto_results.
    events()``): what ``harness.Bench.traced_call`` returns, ``kernels``,
    ``spans`` (``bench.*``) and ``window_s`` in seconds from
    ``bench.generate``'s start, and

    - ``program_spans``: the program's spans on the host, (name, start,
      end), in the same seconds;
    - ``launched_at``: each entry of ``kernels``' launch time on the host;
    - ``launched_in``: the span each entry of ``kernels`` is attributed to
      (the innermost program span open at its launch, else the innermost
      ``bench.*`` span)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, spans, program = [], [], []
    runtime: Dict[int, int] = {}
    ops: Dict[int, int] = {}
    for e in events:
        name = e.name()
        if name.startswith("bench."):
            if e.device_type() != cuda:
                spans.append((name, e.start_ns(), e.end_ns()))
        elif e.device_type() == cuda:
            if not e.is_user_annotation():
                kernels.append((name, e.start_ns(), e.end_ns(),
                                e.correlation_id(),
                                e.linked_correlation_id()))
        elif e.is_user_annotation():
            if is_program(name):
                program.append((name, e.start_ns(), e.end_ns()))
        else:
            where = runtime if name.startswith(RUNTIME) else ops
            c, t = e.correlation_id(), e.start_ns()
            where[c] = min(where.get(c, t), t)
    lo, hi = next((a, b) for n, a, b in spans if n == "bench.generate")
    kept = [k for k in kernels if k[1] >= lo and k[2] <= hi]
    launched = [runtime.get(corr, ops.get(linked) if linked else None)
                for _, _, _, corr, linked in kept]

    def sec(t):
        return None if t is None else (t - lo) / 1e9

    bench = [(n, sec(a), sec(b)) for n, a, b in spans]
    prog = [(n, sec(a), sec(b)) for n, a, b in program]
    at = [sec(t) for t in launched]
    found = [t for t in at if t is not None]
    names = iter(_attribute(prog, bench, found))
    return {"kernels": [(n, sec(a), sec(b)) for n, a, b, _, _ in kept],
            "spans": bench,
            "window_s": (hi - lo) / 1e9,
            "program_spans": prog,
            "launched_at": at,
            "launched_in": [None if t is None else next(names) for t in at]}


def host_spans(events: Iterable[Dict]) -> List[Span]:
    """The program's spans of a telemetry's Chrome trace events (B/E pairs
    on their tracks), as (name, start, end) in seconds from the first
    ``serve.generate``'s start."""
    open_: Dict[int, List[Tuple[str, float]]] = {}
    out: List[Span] = []
    for ev in events:
        if ev["ph"] == "B":
            open_.setdefault(ev["tid"], []).append((ev["name"], ev["ts"]))
        elif ev["ph"] == "E":
            name, ts = open_[ev["tid"]].pop()
            out.append((name, ts / 1e6, ev["ts"] / 1e6))
    t0 = min((a for n, a, _ in out if n == "serve.generate"), default=0.0)
    return sorted(((n, a - t0, b - t0) for n, a, b in out),
                  key=lambda s: (s[1], -s[2]))


def spanned_call(bench, seed: int, k: int, drain: bool = False):
    """Call ``k`` of the seed's traffic through ``bench`` (a
    ``harness.Bench``) with the program's telemetry installed and no
    profiler: (the call, its spans on the host clock).

    With ``drain``, each block's decode step (a module's ``step``) first
    waits, inside a ``DRAIN`` span, until the device has run everything
    launched before it. A block launches a few dozen operations, so none of
    them then waits for room in the device's launch queue: a decode step's
    time outside its ``DRAIN`` and ``serve.readback`` spans is the host's
    own work, however long the card takes."""
    from repro_torch.core.telemetry import Telemetry, telemetry_scope
    tel = Telemetry()
    blocks = [m for m in bench.srv.model.modules()
              if "step" in type(m).__dict__] if drain else []
    cuda = bench.device.type == "cuda"
    for m in blocks:
        m.step = _drained(m.step, tel, cuda)
    try:
        with telemetry_scope(tel):
            call = bench.call(seed, k, record=False)
    finally:
        for m in blocks:
            del m.step
    return call, host_spans(tel.tracer.events())


def _drained(step, tel, cuda: bool):
    import torch

    def drained(*args, **kwargs):
        with tel.span(DRAIN):
            if cuda:
                torch.cuda.synchronize()
        return step(*args, **kwargs)
    return drained


def profiled_call(bench, seed: int, k: int):
    """Call ``k`` under ``torch.profiler`` inside a ``bench.generate``
    range, with the benchmark's spans and the program's telemetry
    installed: (the call, ``convert``'s trace)."""
    import torch
    from repro_torch.core.telemetry import Telemetry, telemetry_scope
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    bench.rec.spans = True
    t0 = time.perf_counter()
    try:
        with torch.profiler.profile(activities=acts) as prof, \
                telemetry_scope(Telemetry()):
            with torch.profiler.record_function("bench.generate"):
                call = bench.call(seed, k, record=False)
    finally:
        bench.rec.spans = False
    tr = convert(prof.profiler.kineto_results.events())
    print(f"[bench] profiled call: {len(tr['kernels'])} device operations "
          f"({sum(t is None for t in tr['launched_at'])} with no launch "
          f"found), {len(tr['program_spans'])} program spans, "
          f"{time.perf_counter() - t0:.1f} s with the profiler's processing",
          file=sys.stderr)
    return call, tr


# ---------------------------------------------------------------------------
# what the readers use
# ---------------------------------------------------------------------------

def count(spans: Sequence[Span], name: str) -> int:
    return sum(n == name for n, _, _ in spans)


class _Cover:
    """The union of the spans named in ``names``, for membership tests."""

    def __init__(self, spans: Sequence[Span], names: Sequence[str]):
        merged: List[List[float]] = []
        for a, b in sorted((a, b) for n, a, b in spans if n in names):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def launched_inside(tr: Dict, *within: Sequence[str],
                    outside: Sequence[str] = ()
                    ) -> List[Tuple[str, float, float]]:
    """The entries of ``tr["kernels"]`` launched inside a program span
    named in each list of ``within`` and inside none named in
    ``outside``."""
    inside = [_Cover(tr["program_spans"], names) for names in within]
    not_in = _Cover(tr["program_spans"], outside)
    return [kern for kern, t in zip(tr["kernels"], tr["launched_at"])
            if t is not None and all(t in c for c in inside)
            and t not in not_in]


def busy_ms(kernels: Iterable[Tuple[str, float, float]]) -> float:
    """Device-busy milliseconds of ``kernels`` (union of their intervals)."""
    return yardstick.union_busy((a, b) for _, a, b in kernels) * 1e3


def device_ms_by_span(tr: Dict) -> Dict[str, float]:
    """Device milliseconds by the span each operation is attributed to
    (``launched_in``; "none" where no launch was found)."""
    out: Dict[str, float] = {}
    for (_, a, b), span in zip(tr["kernels"], tr["launched_in"]):
        key = span or "none"
        out[key] = out.get(key, 0.0) + (b - a) * 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_by_span(tr: Dict) -> Dict[str, List[float]]:
    """The traced call's idle gaps (no device operation) in seconds, by the
    innermost program span open on the host at each gap's middle, else the
    innermost ``bench.*`` span other than ``bench.generate``, else
    ``bench.generate``."""
    iv = [(a, b) for _, a, b in tr["kernels"]]
    gaps = yardstick.idle_gaps(iv, 0.0, tr["window_s"])
    inner = [s for s in tr["spans"] if s[0] != "bench.generate"]
    names = _attribute(tr["program_spans"], inner,
                       [(a + b) / 2 for a, b in gaps])
    out: Dict[str, List[float]] = {}
    for (a, b), name in zip(gaps, names):
        out.setdefault(name or "bench.generate", []).append(b - a)
    return dict(sorted(out.items(), key=lambda kv: -sum(kv[1])))


def host_self_s(spans: Sequence[Span], name: str, minus: Sequence[str]
                ) -> List[float]:
    """For each span ``name``, its length less the spans named in ``minus``
    inside it, in seconds."""
    out = []
    for n, a, b in spans:
        if n == name:
            out.append((b - a) - sum(y - x for m, x, y in spans
                                     if m in minus and a <= x and y <= b))
    return out


# ---------------------------------------------------------------------------
# a traced run of a cell, with the program's spans
# ---------------------------------------------------------------------------

def run(c, seed: int, seconds: float, device="cuda",
        t_start: Optional[float] = None) -> Dict:
    """A traced run of the cell ``c`` (a ``harness.Cell``) with the
    program's spans: set-up and the window as ``harness.run_cell`` makes
    them, then call ``k`` (the window's count) with the spans off, on, on
    and off, once drained (its spans feed the metrics that read the host's
    clock) and once profiled. Returns the manifest's per-layer metrics of
    the cell and every metric of ``SPAN_METRICS`` that finds its spans, the
    calls' times, whether their tokens agree, the B5 launch check, and
    device time and idle gaps by span."""
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_scan
    from . import harness
    t_start = time.perf_counter() if t_start is None else t_start
    b = harness.Bench(c, device)
    b.load(seed)
    b.warm_up(seed)
    setup_s = time.perf_counter() - t_start
    calls, window_s = b.window(seed, seconds)
    k = len(calls)
    # call k with the spans off, on, on, off: the spans' cost in turns
    plain = [b.call(seed, k, record=False)]
    spanned = [spanned_call(b, seed, k) for _ in range(2)]
    plain.append(b.call(seed, k, record=False))
    drained, host = spanned_call(b, seed, k, drain=True)
    n0 = ssd_scan.ssd_intra_folded.launches
    profiled, tr = profiled_call(b, seed, k)
    b5_launches = ssd_scan.ssd_intra_folded.launches - n0
    on_cuda = b.device.type == "cuda"
    t = c.traffic
    ref_mod = harness.reference(c.conf)
    ctx = {"conf": c.conf, "traffic": t, "calls": calls,
           "window_s": window_s, "setup_s": setup_s, "trace": tr,
           "program_spans": host, "reference": ref_mod,
           "flops": ref_mod.flops(c.conf, t.batch, t.prompt_len,
                                  t.new_tokens)}
    b.close()
    metrics = {}
    for name in [m["name"] for m in c.per_layer] + list(SPAN_METRICS):
        v = harness.reader(name)(ctx)
        if v is not None:
            metrics[name] = v

    def per_step(*cs):
        steps = sum(x.steps for x in cs)
        return sum(x.decode_s for x in cs) / steps * 1e3 if steps else None

    def ttft(x):
        return (x.t_first - x.t0) * 1e3

    waits = [y - x for n, x, y in spanned[0][1]
             if n == "serve.readback"][1:]
    own = host_self_s(spanned[0][1], "serve.decode_step",
                      ("serve.readback",))
    idle = idle_by_span(tr)
    b5 = [i for i, (n, _, _) in enumerate(tr["kernels"])
          if "ssd_wgmma_kernel" in n or "ssd_mma_kernel" in n]
    intra = [i for i, s in enumerate(tr["launched_in"]) if s == "ssd.intra"]
    return {
        "workload": c.name, "seed": seed, "metrics": metrics,
        "device": torch.cuda.get_device_name() if on_cuda else "cpu",
        "setup_s": setup_s,
        "window": {"calls": k, "window_s": window_s,
                   "decode_ms_per_step": per_step(*calls),
                   "ttft_ms": sorted(ttft(x) for x in calls)},
        "plain_calls": {"decode_ms_per_step": [per_step(x) for x in plain],
                        "ttft_ms": [ttft(x) for x in plain]},
        "spanned_calls": {"decode_ms_per_step": [per_step(x)
                                                 for x, _ in spanned],
                          "ttft_ms": [ttft(x) for x, _ in spanned],
                          "readback_ms_per_step":
                              sum(waits) / len(waits) * 1e3 if waits
                              else None,
                          "host_ms_per_step_undrained":
                              sum(own) / len(own) * 1e3 if own else None},
        "drained_call": {"decode_ms_per_step": per_step(drained),
                         "ttft_ms": ttft(drained)},
        "profiled_call": {"decode_ms_per_step": per_step(profiled),
                          "ttft_ms": ttft(profiled),
                          "busy_s": busy_ms(tr["kernels"]) / 1e3,
                          "window_s": tr["window_s"],
                          "prefill_busy_ms": busy_ms(launched_inside(
                              tr, ["serve.prefill"])),
                          "b5_ms": sum(tr["kernels"][i][2] -
                                       tr["kernels"][i][1] for i in b5)
                          * 1e3},
        "tokens_equal_on_off": all(
            np.array_equal(plain[0].served, x.served)
            for x in [plain[1], profiled, drained]
            + [y for y, _ in spanned]),
        "b5": {"launches": b5_launches, "by_name": len(b5),
               "launched_in_ssd_intra": len(intra),
               "by_name_and_in_ssd_intra": len(set(b5) & set(intra)),
               "others_in_ssd_intra": sorted(
                   {tr["kernels"][i][0][:60] for i in set(intra) - set(b5)})},
        "unattributed": sum(s is None for s in tr["launched_in"]),
        "device_ms_by_span": device_ms_by_span(tr),
        "idle_s_by_span": {n: [sum(g), max(g), len(g)]
                           for n, g in list(idle.items())[:10]},
        "program_span_counts": {n: count(tr["program_spans"], n)
                                for n in sorted({s[0] for s in
                                                 tr["program_spans"]})},
    }


def main(argv=None) -> int:
    import argparse
    import json
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import harness
    out = run(harness.cell(args.workload), args.seed, args.seconds,
              t_start=t_start)
    print("[bench] device ms by span: " + ", ".join(
        f"{n} {v:.3f}" for n, v in
        list(out["device_ms_by_span"].items())[:10]), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
