"""One run of one benchmark cell: set-up, a measured window of served calls,
optionally one traced call, the output check, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file the manifest names, its
traffic in ``bench/traffic/<traffic>.json``, its limits in
``bench/limits/<workload>.json``, each metric's reader in
``bench/metrics/<metric>.py``, the configuration's plain reference, its model
FLOPs and its kernels' launch shapes in ``bench/reference/<reference>.py``,
and, where the configuration names one, the launcher that runs its cell
across chips in ``bench/launchers/<launcher>.py``. A later cell or metric is
new files and new manifest entries.

The measured window drives ``repro_torch.launch.serve.Server.generate`` in a
closed loop. The benchmark makes the weights from the seed on the device,
loads them with ``load_state_dict``, and wraps the model instance's
``prefill`` and ``decode_step`` to read the time of each call's first token on
the host and to keep one row's logits of each call for the output check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import yardstick
from .traffic import Traffic, load as load_traffic

__all__ = ["ROOT", "Cell", "cell", "reader", "reference", "launcher",
           "forbidden_modules", "draw_weights", "Bench", "run_cell"]

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a stream of the seed apart from every call's (calls use k < 2**40)
CHECK_STREAM, WARMUP_CALL = 1 << 40, (1 << 40) + 1


@dataclasses.dataclass
class Cell:
    """A workload of the manifest with everything it names, loaded."""
    name: str
    chips: int
    conf: Dict
    traffic: Traffic
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s manifest, its files read."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in man["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    conf_entry = next(c for c in man["configs"] if c["name"] == w["config"])
    bench = root / "bench"
    return Cell(
        name=workload, chips=w["chips"],
        conf=json.loads((root / conf_entry["file"]).read_text()),
        traffic=load_traffic(bench / "traffic" / f"{w['traffic']}.json"),
        limits=json.loads((bench / "limits" / f"{workload}.json")
                          .read_text())["limits"],
        end_to_end=[m for m in man["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in man["per_layer"] if _applies(m, workload)])


def _load(kind: str, name: str, root: Path):
    """The module ``bench/<kind>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + re.sub(r"\W", "_", name),
        root / "bench" / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT) -> Callable[[Dict], Optional[float]]:
    """The ``read(ctx)`` of ``bench/metrics/<name>.py``."""
    return _load("metrics", name, root).read


def reference(conf: Dict):
    """The configuration's plain reference module: ``logits_at``, ``flops``
    and the launch shapes of the kernels its model runs."""
    return importlib.import_module(f"bench.reference.{conf['reference']}")


def launcher(c: "Cell", root: Path = ROOT) -> Callable[..., Dict]:
    """What runs the cell ``c`` once: ``run_cell`` here, in this process on
    one device, or the ``run_cell`` of ``bench/launchers/<launcher>.py``
    where the configuration names a ``launcher`` (a cell across chips: its
    ranks, their peak on the fullest chip). Both take ``run_cell``'s
    arguments and return the result line's object."""
    name = c.conf.get("launcher")
    return run_cell if name is None else _load("launchers", name,
                                               root).run_cell


def forbidden_modules(names=None) -> List[str]:
    """Those of ``names`` (default: the loaded modules) whose top-level name
    is JAX's or the JAX package's, compared whole."""
    return sorted(m for m in (sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def _seed(seed: int) -> int:
    return seed % (1 << 63)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _rule(rules: List[Dict], name: str) -> int:
    for i, r in enumerate(rules):
        if re.search(r["match"], name):
            return i
    raise KeyError(f"no init rule matches weight {name!r}")


def draw_weights(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 rules: List[Dict], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every weight of ``shapes`` (name -> shape, dtype) drawn from ``seed``
    on ``device`` by the first of ``rules`` whose ``match`` it meets: one
    draw for all the weights that share a rule, a dtype and a scale, the
    weights views of it. Rules: ``normal`` (``mean``, and ``std`` or
    ``1/sqrt(shape[fan_in_dim])``), ``uniform`` (``lo``, ``hi``) and
    ``inv_softplus_log_uniform`` (softplus^-1 of a value log-uniform in
    ``[lo, hi]``)."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed))
    groups: Dict[Tuple, List[str]] = {}
    for name, (shape, dtype) in shapes.items():
        i = _rule(rules, name)
        r = rules[i]
        std = r.get("std")
        if r["dist"] == "normal" and std is None:
            std = 1.0 / math.sqrt(shape[r["fan_in_dim"]])
        groups.setdefault((i, dtype, std), []).append(name)
    out = {}
    for (i, dtype, std), names in groups.items():
        r = rules[i]
        total = sum(math.prod(shapes[n][0]) for n in names)
        if r["dist"] == "normal":
            flat = torch.empty(total, dtype=dtype, device=device)
            flat.normal_(r.get("mean", 0.0), std, generator=gen)
        elif r["dist"] == "uniform":
            flat = torch.empty(total, dtype=dtype, device=device)
            flat.uniform_(r["lo"], r["hi"], generator=gen)
        elif r["dist"] == "inv_softplus_log_uniform":
            v = torch.empty(total, dtype=torch.float32, device=device)
            v.uniform_(math.log(r["lo"]), math.log(r["hi"]), generator=gen)
            v.exp_()
            flat = (v + torch.log(-torch.expm1(-v))).to(dtype)
        else:
            raise ValueError(f"unknown init dist {r['dist']!r}")
        off = 0
        for n in names:
            shape = shapes[n][0]
            size = math.prod(shape)
            out[n] = flat[off:off + size].view(shape)
            off += size
    return out


# ---------------------------------------------------------------------------
# the served path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Call:
    """One served call of the window, as the benchmark saw it."""
    prompt: np.ndarray          # the recorded rows' prompts (R, prompt_len)
    served: np.ndarray          # the recorded rows' served tokens (R, new)
    t0: float
    t_first: float
    t1: float
    decode_s: float
    steps: int                  # decode steps the call ran
    rows: int
    failed: int                 # rows that did not get every token
    logits: Optional[torch.Tensor]   # the recorded rows' (R, new, V)


class _Recorder:
    """Wraps the model instance's ``prefill`` and ``decode_step``: the time
    the first decode step starts (the first token is then on the host), some
    rows' logits of every step, and with ``spans`` a profiler range around
    each."""

    def __init__(self, model):
        self.prefill0, self.decode0 = model.prefill, model.decode_step
        model.prefill, model.decode_step = self.prefill, self.decode_step
        self.spans = False
        self.begin(None)

    def begin(self, rows: Optional[torch.Tensor]) -> None:
        self.rows, self.t_first, self.kept = rows, None, []

    def _keep(self, logits: torch.Tensor) -> None:
        if self.rows is not None:
            self.kept.append(logits[self.rows, -1])

    def _span(self, name: str):
        return torch.profiler.record_function(name) if self.spans \
            else contextlib.nullcontext()

    def prefill(self, *args, **kwargs):
        with self._span("bench.prefill"):
            out = self.prefill0(*args, **kwargs)
        self._keep(out[0])
        return out

    def decode_step(self, *args, **kwargs):
        if self.t_first is None:
            self.t_first = time.perf_counter()
        with self._span("bench.decode_step"):
            out = self.decode0(*args, **kwargs)
        self._keep(out[0])
        return out


class Bench:
    """The server of one cell with the benchmark's weights and recorder."""

    def __init__(self, c: Cell, device):
        from repro_torch.configs import get
        from repro_torch.launch.serve import Server
        self.cell, self.device = c, torch.device(device)
        self.conf = c.conf
        port = self.conf["port"]
        self.cfg = dataclasses.replace(get(port["arch"]), **port["fields"])
        t = c.traffic
        self.srv = Server(self.cfg, t.batch, t.prompt_len, t.new_tokens,
                          eos_id=-1, device=self.device)
        self.shapes = {n: (tuple(v.shape), v.dtype)
                       for n, v in self.srv.model.state_dict().items()}
        self.rec = _Recorder(self.srv.model)

    def weights(self, seed: int) -> Dict[str, torch.Tensor]:
        return draw_weights(self.shapes, self.conf["init"], seed,
                            self.device)

    def load(self, seed: int) -> None:
        """The seed's weights into the program."""
        w = self.weights(seed)
        self.srv.model.load_state_dict(w)
        del w

    def call(self, seed: int, k: int, record: bool = True) -> Call:
        """Serve batch ``k`` of the seed's traffic through
        ``Server.generate``."""
        t = self.cell.traffic
        tokens, rows = t.batch_at(_seed(seed), k, self.cfg.vocab)
        self.rec.begin(torch.as_tensor(rows, device=self.device)
                       if record else None)
        t0 = time.perf_counter()
        out = self.srv.generate({"tokens": tokens})
        t1 = time.perf_counter()
        served = out["tokens"]
        full = served.shape[1] == self.srv.max_new
        kept = torch.stack(self.rec.kept, 1) if self.rec.kept else None
        return Call(prompt=tokens[rows], served=served[rows], t0=t0,
                    t_first=self.rec.t_first or t1, t1=t1,
                    decode_s=out["decode_s"], steps=served.shape[1] - 1,
                    rows=t.batch, failed=t.batch - served.shape[0] * full,
                    logits=kept)

    def warm_up(self, seed: int) -> None:
        """One call of a prefill and one decode step at the cell's shapes:
        every shape its traffic uses (the decode steps all share one)."""
        new, self.srv.max_new = self.srv.max_new, 2
        try:
            self.call(seed, WARMUP_CALL, record=False)
        finally:
            self.srv.max_new = new

    def window(self, seed: int, seconds: float) -> Tuple[List[Call], float]:
        """Calls in a closed loop until ``seconds`` have passed; returns the
        calls and the window's length (its start to the last call's end)."""
        calls: List[Call] = []
        start = time.perf_counter()
        while True:
            calls.append(self.call(seed, len(calls)))
            if calls[-1].t1 - start >= seconds:
                return calls, calls[-1].t1 - start

    def traced_call(self, seed: int, k: int) -> Dict:
        """One call under ``torch.profiler`` with the benchmark's spans:
        device intervals and spans in seconds from the call's start."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.rec.spans = True
        t0 = time.perf_counter()
        try:
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("bench.generate"):
                    self.call(seed, k, record=False)
        finally:
            self.rec.spans = False
        cuda = torch.autograd.DeviceType.CUDA
        kernels, spans = [], []
        for e in prof.profiler.kineto_results.events():
            if e.name().startswith("bench."):
                if e.device_type() != cuda:
                    spans.append((e.name(), e.start_ns(), e.end_ns()))
            elif e.device_type() == cuda and not e.is_user_annotation():
                kernels.append((e.name(), e.start_ns(), e.end_ns()))
        lo, hi = next((a, b) for n, a, b in spans if n == "bench.generate")
        print(f"[bench] traced call: {len(kernels)} device operations, "
              f"{len(spans)} spans, {time.perf_counter() - t0:.1f} s with "
              f"the profiler's processing", file=sys.stderr)
        return {"kernels": [(n, (a - lo) / 1e9, (b - lo) / 1e9)
                            for n, a, b in kernels if a >= lo and b <= hi],
                "spans": [(n, (a - lo) / 1e9, (b - lo) / 1e9)
                          for n, a, b in spans],
                "window_s": (hi - lo) / 1e9}

    def close(self) -> None:
        """Free the program and everything it holds on the device."""
        del self.srv, self.rec
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------

def _picks(calls: List[Call], seed: int, n: int) -> List[Call]:
    rng = np.random.default_rng([_seed(seed), CHECK_STREAM])
    idx = rng.choice(len(calls), size=min(n, len(calls)), replace=False)
    return [calls[i] for i in sorted(idx)]


def _gap(ref: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's
    best, at each position."""
    return ref.max(-1).values - ref.gather(-1, tok[..., None])[..., 0]


def _logit_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative L2 distance from the reference at one
    position."""
    return ((x - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def _logit_dev(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest single logit's distance from the reference, in units of
    the reference logits' RMS at its position."""
    rms = ref.square().mean(-1).sqrt()
    return ((x - ref).abs().amax(-1) / rms).max().item()


def judge(conf: Dict, calls: List[Call], weights: Dict[str, torch.Tensor],
          device, control: bool = False) -> Dict[str, float]:
    """The compared numbers over ``calls`` (each with its rows' prompts,
    served tokens and logits), against the reference run once over each
    prompt with its served tokens, float32 with TF32 off:

    - ``logit_err``: the largest relative L2 distance of the served logits
      from the reference's at one position;
    - ``logit_dev``: the largest distance of one served logit from the
      reference's, in units of the reference logits' RMS at its position;
    - ``token_mismatch``: served tokens that are not the greedy token of the
      served logits.

    With ``control`` also the first two of the reference computed with
    float8 matmuls in the program's place (``control_*``), and, for the
    record, ``token_gap`` and ``control_token_gap``: the widest gap by which
    a served (or the control's greedy) token's reference logit lies below
    the reference's best."""
    ref_mod = reference(conf)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompt = calls[0].prompt.shape[1]
    seqs = np.concatenate([np.concatenate([c.prompt, c.served[:, :-1]], 1)
                           for c in calls])
    positions = range(prompt - 1, seqs.shape[1])
    toks = torch.as_tensor(seqs, device=device)
    served = torch.as_tensor(np.concatenate([c.served for c in calls]),
                             device=device).long()
    ref = ref_mod.logits_at(conf, weights.__getitem__, toks, positions)
    prog = torch.cat([c.logits for c in calls]).to(device).float()
    out = {"logit_err": _logit_err(prog, ref),
           "logit_dev": _logit_dev(prog, ref),
           "token_mismatch": float((prog.argmax(-1) != served).sum())}
    if control:
        low = ref_mod.logits_at(conf, weights.__getitem__, toks, positions,
                                matmul="fp8")
        out.update(control_logit_err=_logit_err(low, ref),
                   control_logit_dev=_logit_dev(low, ref),
                   token_gap=_gap(ref, served).max().item(),
                   control_token_gap=_gap(ref, low.argmax(-1)).max().item())
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _trace_summary(tr: Dict) -> Tuple[float, Dict]:
    """Busy seconds of the traced call and the breakdown: the device
    operations that took most time, and the idle time by the benchmark span
    the host was in."""
    iv = [(a, b) for _, a, b in tr["kernels"]]
    busy = yardstick.union_busy(iv)
    per_op: Dict[str, float] = {}
    for n, a, b in tr["kernels"]:
        per_op[n[:120]] = per_op.get(n[:120], 0.0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    inner = [s for s in tr["spans"] if s[0] != "bench.generate"]
    idle: Dict[str, List[float]] = {}
    for a, b in yardstick.idle_gaps(iv, 0.0, tr["window_s"]):
        mid = (a + b) / 2
        label = next((n for n, s0, s1 in inner if s0 <= mid <= s1),
                     "bench.generate")
        idle.setdefault(label, []).append(b - a)
    gaps = []
    for label, g in sorted(idle.items(), key=lambda kv: -sum(kv[1])):
        gaps += [[f"{label} total", sum(g)], [f"{label} longest", max(g)]]
    return busy, {"device_ops": [[n, s] for n, s in ops],
                  "idle_gaps": gaps[:10]}


def run_cell(c: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             root: Path = ROOT) -> Dict:
    """One run of the cell ``c``; returns the result line's object.
    ``t_start`` is the process's start on ``time.perf_counter``. Each metric's
    reader gets ``ctx``: the configuration (``conf``) and its reference
    module (``reference``), the ``traffic``, the window's ``calls`` and
    ``window_s``, ``setup_s``, the traced call (``trace``, or None) and the
    model ``flops`` of one call."""
    t_start = time.perf_counter() if t_start is None else t_start
    b = Bench(c, device)
    conf = b.conf
    b.load(seed)
    on_cuda = b.device.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    b.warm_up(seed)
    setup_s = time.perf_counter() - t_start

    calls, window_s = b.window(seed, seconds)
    dur = sorted(k.t1 - k.t0 for k in calls)
    print(f"[bench] window {window_s:.3f} s: {len(calls)} calls of "
          f"{dur[0]:.3f}-{dur[-1]:.3f} s (median {dur[len(dur) // 2]:.3f})",
          file=sys.stderr)
    tr = b.traced_call(seed, len(calls)) if trace else None
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    t, ref_mod = c.traffic, reference(conf)
    ctx = {"conf": conf, "traffic": t, "calls": calls, "window_s": window_s,
           "setup_s": setup_s, "trace": tr, "reference": ref_mod,
           "flops": ref_mod.flops(conf, t.batch, t.prompt_len, t.new_tokens)}
    checked = _picks(calls, seed, t.check_calls)
    keep = {id(k) for k in checked}
    for k in calls:
        if id(k) not in keep:
            k.logits = None
    b.close()
    nums = judge(conf, checked, b.weights(seed), device)
    attempted = sum(k.rows for k in calls)
    failed = sum(k.failed for k in calls)
    checks = {n: {"value": v, "limit": c.limits[n]} for n, v in nums.items()}
    correct = failed == 0 and all(v["value"] <= v["limit"]
                                  for v in checks.values())
    chosen = c.per_layer if trace else c.end_to_end
    metrics = {}
    for m in chosen:
        v = reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else b.device.type,
           "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        busy, result["breakdown"] = _trace_summary(tr)
        dev.update(busy_s=busy, window_s=tr["window_s"])
    result["checks"] = checks
    return result

