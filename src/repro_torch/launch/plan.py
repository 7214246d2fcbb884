"""Plan the placement of one architecture's serving shapes over the
TPU-fleet environment with one batched PSO-GA fleet — the port's
counterpart of ``repro.launch.serve --plan`` (its planning block only).

    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b \
        --traffic bursty

Runs on the card unless ``--device cpu`` is given. ``--traffic SCENARIO``
plans under a request stream of that arrival family (DESIGN.md §10), as
``serve --plan --traffic`` does, and reports each plan's held-out
deadline-miss tails.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from ..configs import SHAPES, get
from ..core import (TRAFFIC_KINDS, PSOGAConfig, TrafficConfig,
                    plan_offload_batch, tpu_fleet_environment)

#: the serve planner's settings (``repro/launch/serve.py``)
DEADLINE_RATIO = 1.5
DEFAULT_PSO = PSOGAConfig(pop_size=48, max_iters=200, stall_iters=40)


def plan_serving_shapes(cfg, *, device, pop: int = DEFAULT_PSO.pop_size,
                        iters: int = DEFAULT_PSO.max_iters,
                        traffic: Optional[str] = None,
                        traffic_rate: float = 0.5, prefix: str = "plan"):
    """Plan ``cfg``'s serving shapes as one batched fleet solve and print
    each plan, as ``serve --plan`` does; returns the plans."""
    shapes = [s for s in SHAPES if s.kind != "train"]
    pso = PSOGAConfig(pop_size=pop, max_iters=iters,
                      stall_iters=DEFAULT_PSO.stall_iters)
    tc = None if traffic is None else TrafficConfig(kind=traffic,
                                                    rate=traffic_rate)
    t0 = time.perf_counter()
    plans = plan_offload_batch([(cfg, s, DEADLINE_RATIO) for s in shapes],
                               env=tpu_fleet_environment(), pso=pso,
                               device=device, traffic=tc)
    wall = time.perf_counter() - t0
    tag = f" under {traffic} traffic" if traffic else ""
    for shape, plan in zip(shapes, plans):
        print(f"[{prefix}] PSO-GA fleet placement for {shape.name}{tag} "
              f"(backend={plan.backend}):")
        print(plan.summary())
    print(f"[{prefix}] {len(plans)} shapes planned in {wall:.3f} s")
    return plans


def add_plan_args(ap: argparse.ArgumentParser) -> None:
    """The planner's options, shared with ``launch/serve.py --plan``."""
    ap.add_argument("--pop", type=int, default=DEFAULT_PSO.pop_size)
    ap.add_argument("--iters", type=int, default=DEFAULT_PSO.max_iters)
    ap.add_argument("--traffic", default=None, metavar="SCENARIO",
                    choices=TRAFFIC_KINDS,
                    help="plan under a request stream of this arrival "
                         "family; the report shows each plan's held-out "
                         "p50/p95/p99 deadline-miss rate")
    ap.add_argument("--traffic-rate", type=float, default=0.5,
                    help="mean request arrivals/s per app for --traffic")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    add_plan_args(ap)
    args = ap.parse_args(argv)
    plan_serving_shapes(get(args.arch), device=args.device, pop=args.pop,
                        iters=args.iters, traffic=args.traffic,
                        traffic_rate=args.traffic_rate)


if __name__ == "__main__":
    main()
