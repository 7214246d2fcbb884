"""Where a planning solve's time goes on the card: host wall clock, device
kernel time by name (``torch.profiler``), and the share of the wall during
which the device ran no kernel.

    PYTHONPATH=src python -m repro_torch.launch.breakdown [--traffic bursty]

Profiles two solves after a warm-up of each: the qwen3-0.6b serving plan
(``launch/plan.py``'s settings) and the paper's Fig. 8 problem at the
paper's PSO-GA settings; with ``--traffic SCENARIO`` also the qwen3-0.6b
plan under that request stream (``launch/plan.py --traffic``, rate 0.5).
Prints one JSON line per solve; chrome traces go to ``--trace-dir`` when
given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from ..configs import SHAPES, get
from ..core import (TRAFFIC_KINDS, TrafficConfig, plan_offload_batch,
                    run_pso_ga, tpu_fleet_environment)
from ..core.paper import PAPER_PSO, fig8_problem
from ..kernels import schedule_sim, traffic_sim
from .plan import DEADLINE_RATIO, DEFAULT_PSO


def profile(tag: str, solve: Callable[[], object],
            trace_dir: Optional[Path]) -> dict:
    """Run ``solve`` once to warm up, then once under the profiler."""
    solve()
    torch.cuda.synchronize()
    schedule_sim.schedule_replay.launches = 0
    traffic_sim.traffic_replay.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (ev.count, dev_us / 1e3)
    busy_ms = sum(ms for _, ms in kernels.values())

    def by_name(name):
        hits = [(c, ms) for k, (c, ms) in kernels.items() if name in k]
        n, ms = sum(c for c, _ in hits), sum(ms for _, ms in hits)
        return ms, ms / n if n else None

    replay_ms, replay_per = by_name("schedule_replay_kernel")
    traffic_ms, traffic_per = by_name("traffic_replay_kernel")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / f"{tag}.json"))
    return {"solve": tag, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms, "replay_kernel_ms": replay_ms,
            "replay_ms_per_launch": replay_per,
            "traffic_kernel_ms": traffic_ms,
            "traffic_ms_per_launch": traffic_per,
            "idle_share": 1.0 - busy_ms / (wall * 1e3),
            "replay_launches": schedule_sim.schedule_replay.launches,
            "traffic_launches": traffic_sim.traffic_replay.launches,
            "device_kernels": len(kernels),
            "top": [{"kernel": k[:80], "count": c, "ms": ms}
                    for k, (c, ms) in top]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--trace-dir", type=Path, default=None)
    ap.add_argument("--traffic", default=None, metavar="SCENARIO",
                    choices=TRAFFIC_KINDS,
                    help="also profile the plan under this arrival family")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[breakdown] {smi} torch {torch.__version__}")

    cfg, env = get(args.arch), tpu_fleet_environment()
    requests = [(cfg, s, DEADLINE_RATIO) for s in SHAPES if s.kind != "train"]
    print(json.dumps(profile(f"plan-{args.arch}", lambda: plan_offload_batch(
        requests, env=env, pso=DEFAULT_PSO), args.trace_dir)))
    if args.traffic:
        tc = TrafficConfig(kind=args.traffic, rate=0.5)
        print(json.dumps(profile(
            f"plan-{args.arch}-{args.traffic}", lambda: plan_offload_batch(
                requests, env=env, pso=DEFAULT_PSO, traffic=tc),
            args.trace_dir)))

    dag8, env8 = fig8_problem()
    print(json.dumps(profile("fig8", lambda: run_pso_ga(dag8, env8, PAPER_PSO),
                             args.trace_dir)))


if __name__ == "__main__":
    main()
