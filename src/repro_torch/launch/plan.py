"""Plan the placement of one architecture's serving shapes over the
TPU-fleet environment with one batched PSO-GA fleet — the port's
counterpart of ``repro.launch.serve --plan`` (its planning block only).

    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b \
        --traffic bursty
    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b \
        --replan congestion [--traffic bursty]
    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b \
        --replan load-surge --traffic bursty

Runs on the card unless ``--device cpu`` is given. ``--traffic SCENARIO``
plans under a request stream of that arrival family (DESIGN.md §10), as
``serve --plan --traffic`` does, and reports each plan's held-out
deadline-miss tails. ``--replan SCENARIO`` then drives the plans through
``--replan-rounds`` rounds of that drift trace (``core.online``), warm
re-planning at each event, as ``serve --plan --replan`` does; it prints
one line per round with the replay kernels' launches. ``--replan
load-surge`` drifts the request stream, so it needs ``--traffic``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from ..configs import SHAPES, get
from ..core import (TRACE_KINDS, TRAFFIC_KINDS, PSOGAConfig, ReplanConfig,
                    TrafficConfig, plan_offload_batch, replan_fleet,
                    sample_trace, tpu_fleet_environment)
from ..kernels.schedule_sim import schedule_replay
from ..kernels.traffic_sim import traffic_replay

#: the serve planner's settings (``repro/launch/serve.py``)
DEADLINE_RATIO = 1.5
DEFAULT_PSO = PSOGAConfig(pop_size=48, max_iters=200, stall_iters=40)


def plan_serving_shapes(cfg, *, device, pop: int = DEFAULT_PSO.pop_size,
                        iters: int = DEFAULT_PSO.max_iters,
                        traffic: Optional[str] = None,
                        traffic_rate: float = 0.5, prefix: str = "plan",
                        replan: Optional[str] = None, replan_rounds: int = 4):
    """Plan ``cfg``'s serving shapes as one batched fleet solve and print
    each plan, as ``serve --plan`` does; with ``replan`` (a drift family
    of ``TRACE_KINDS``) re-plan them through a trace of ``replan_rounds``
    rounds. Returns the plans (and, with ``replan``, the
    ``OnlineReport``)."""
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
    if replan is None:
        return plans
    return plans, replan_plans(plans, replan, replan_rounds, pso, tc,
                               device=device, prefix=prefix)


def replan_plans(plans, scenario: str, rounds: int, pso: PSOGAConfig,
                 traffic: Optional[TrafficConfig], *, device,
                 prefix: str = "plan"):
    """Warm re-plan ``plans`` through ``rounds`` rounds of the drift trace
    ``scenario`` over the TPU fleet (seed 0), with the cold solve's config
    (and, under ``traffic``, its request stream and miss budget), as the
    reference's ``serve --plan --replan`` does. Prints one line per round,
    with its B1 and B2 launches; returns the ``OnlineReport``."""
    trace = sample_trace(scenario, tpu_fleet_environment(), rounds=rounds,
                         seed=0)
    if traffic is not None:
        pso = dataclasses.replace(pso, miss_budget=traffic.miss_budget)

    def report(log, _plans) -> None:
        print(f"[{prefix}] replan round {log.round} ({log.label}): "
              f"{int(log.replanned.sum())}/{len(plans)} plans changed, "
              f"fleet cost ${float(np.sum(log.cost)):.4f}, moved layers "
              f"{log.moved_layers.tolist()}, {log.wall_s * 1e3:.0f}ms, "
              f"launches B1 {schedule_replay.launches} B2 "
              f"{traffic_replay.launches}", flush=True)
        schedule_replay.launches = traffic_replay.launches = 0

    schedule_replay.launches = traffic_replay.launches = 0
    return replan_fleet([p.dag for p in plans], trace,
                        ReplanConfig(pso=pso, traffic=traffic),
                        initial=[p.result for p in plans], device=device,
                        on_round=report)


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
    ap.add_argument("--replan", default=None, metavar="SCENARIO",
                    choices=TRACE_KINDS,
                    help="after planning, warm re-plan through a drift "
                         "trace of this family (load-surge needs "
                         "--traffic)")
    ap.add_argument("--replan-rounds", type=int, default=4,
                    help="rounds of the --replan trace, the cold one "
                         "included")


def check_plan_args(ap: argparse.ArgumentParser, args) -> None:
    """The reference's rules for the shared planner options."""
    if args.replan == "load-surge" and not args.traffic:
        ap.error("--replan load-surge drifts the request stream, which "
                 "only exists with --traffic SCENARIO")
    if args.replan_rounds < 1:
        ap.error("--replan-rounds must be >= 1")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    add_plan_args(ap)
    args = ap.parse_args(argv)
    check_plan_args(ap, args)
    plan_serving_shapes(get(args.arch), device=args.device, pop=args.pop,
                        iters=args.iters, traffic=args.traffic,
                        traffic_rate=args.traffic_rate, replan=args.replan,
                        replan_rounds=args.replan_rounds)


if __name__ == "__main__":
    main()
