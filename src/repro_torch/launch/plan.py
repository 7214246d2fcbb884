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
    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b \
        --serve congestion --chaos --plan-cache --trace-out t.json

Runs on the card unless ``--device cpu`` is given. ``--traffic SCENARIO``
plans under a request stream of that arrival family (DESIGN.md §10), as
``serve --plan --traffic`` does, and reports each plan's held-out
deadline-miss tails. ``--replan SCENARIO`` then drives the plans through
``--replan-rounds`` rounds of that drift trace (``core.online``), warm
re-planning at each event, as ``serve --plan --replan`` does; it prints
one line per round with the replay kernels' launches. ``--replan
load-surge`` drifts the request stream, so it needs ``--traffic``.

``--serve SCENARIO`` runs the always-on planning service
(``core.service.run_service``, DESIGN.md §11) on the plans through
``--serve-rounds`` rounds of that drift trace, as the reference's
``serve --plan --serve`` does: the watchdog (``--slo-s``), the ladder,
deadline triage (``--triage-margin``), rate estimation from observed
arrivals (``--estimate-rates``, queued with ``--async-ingest THREADS``),
the plan cache (``--plan-cache``) and, with ``--chaos``, a fixed fault
script (a solver crash at round 2, a NaN environment at 3, server 1 down
mid-round at 4). A traffic family (``--serve bursty``) serves that
request stream through a ``load-surge`` trace. It prints one line per
round (rungs, breaker, wall, B1 / B2 launches), the availability and
time-to-plan summary and the plan cache's line. ``--trace-out FILE`` and
``--metrics-out DIR`` install one telemetry channel for the whole
planning path and export its Chrome trace and metrics snapshot.

``--mesh host`` shards every solve (plan, re-plan, service) over a device
mesh of the world's ranks (``launch.mesh.make_test_mesh``), as the
reference's ``serve --mesh`` does: a world of one on the card (``nccl``)
unless started by ``torchrun``; plans are bit for bit those of ``--mesh
none``. ``--mesh prod`` needs a world of 256 ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from ..configs import SHAPES, get
from ..core import (TRACE_KINDS, TRAFFIC_KINDS, ChaosConfig, IngestConfig,
                    PlanCacheConfig, PSOGAConfig, ReplanConfig, ServiceConfig,
                    Telemetry, TrafficConfig, plan_offload_batch, replan_fleet,
                    run_service, sample_trace, telemetry_scope,
                    tpu_fleet_environment)
from ..kernels.schedule_sim import schedule_replay
from ..kernels.traffic_sim import traffic_replay
from .mesh import resolve_mesh

#: the serve planner's settings (``repro/launch/serve.py``)
DEADLINE_RATIO = 1.5
DEFAULT_PSO = PSOGAConfig(pop_size=48, max_iters=200, stall_iters=40)


def solver_configs(pop: int, iters: int, traffic: Optional[str],
                   traffic_rate: float):
    """The planner's ``PSOGAConfig`` and, with ``traffic``, its
    ``TrafficConfig``, as the reference's ``serve --plan`` builds them."""
    pso = PSOGAConfig(pop_size=pop, max_iters=iters,
                      stall_iters=DEFAULT_PSO.stall_iters)
    tc = None if traffic is None else TrafficConfig(kind=traffic,
                                                    rate=traffic_rate)
    return pso, tc


def plan_serving_shapes(cfg, *, device, pop: int = DEFAULT_PSO.pop_size,
                        iters: int = DEFAULT_PSO.max_iters,
                        traffic: Optional[str] = None,
                        traffic_rate: float = 0.5, prefix: str = "plan",
                        replan: Optional[str] = None, replan_rounds: int = 4,
                        telemetry=None, mesh=None):
    """Plan ``cfg``'s serving shapes as one batched fleet solve and print
    each plan, as ``serve --plan`` does; with ``replan`` (a drift family
    of ``TRACE_KINDS``) re-plan them through a trace of ``replan_rounds``
    rounds (``telemetry`` goes to ``replan_fleet``). ``mesh`` shards every
    solve. Returns the plans (and, with ``replan``, the ``OnlineReport``).
    """
    shapes = [s for s in SHAPES if s.kind != "train"]
    pso, tc = solver_configs(pop, iters, traffic, traffic_rate)
    t0 = time.perf_counter()
    plans = plan_offload_batch([(cfg, s, DEADLINE_RATIO) for s in shapes],
                               env=tpu_fleet_environment(), pso=pso,
                               device=device, traffic=tc, mesh=mesh)
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
                               device=device, prefix=prefix,
                               telemetry=telemetry, mesh=mesh)


def replan_plans(plans, scenario: str, rounds: int, pso: PSOGAConfig,
                 traffic: Optional[TrafficConfig], *, device,
                 prefix: str = "plan", telemetry=None, mesh=None):
    """Warm re-plan ``plans`` through ``rounds`` rounds of the drift trace
    ``scenario`` over the TPU fleet (seed 0), with the cold solve's config
    (and, under ``traffic``, its request stream and miss budget), as the
    reference's ``serve --plan --replan`` does. Prints one line per round,
    with its B1 and B2 launches; returns the ``OnlineReport``.
    ``telemetry`` goes to ``replan_fleet``; ``mesh`` shards its solves."""
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
                        ReplanConfig(pso=pso, traffic=traffic, mesh=mesh),
                        initial=[p.result for p in plans], device=device,
                        on_round=report, telemetry=telemetry)


def chaos_script(rounds: int) -> ChaosConfig:
    """``--chaos``: the reference's fault script for a ``rounds``-round
    trace — a solver crash at round 2, a NaN environment snapshot at 3,
    server 1 down mid-round at 4 (each clipped to the last round)."""
    last = max(1, rounds - 1)
    return ChaosConfig(crash_rounds=(min(2, last),),
                       nan_env_rounds=(min(3, last),),
                       mid_round_down={min(4, last): 1})


def serve_plans(plans, scenario: str, rounds: int, pso: PSOGAConfig,
                traffic: Optional[TrafficConfig], *, device,
                chaos: bool = False, slo_s: float = float("inf"),
                triage_margin: float = 0.0, estimate_rates: bool = False,
                plan_cache: bool = False,
                async_ingest: Optional[int] = None, telemetry=None,
                prefix: str = "plan", mesh=None):
    """Run the always-on planning service on ``plans`` through ``rounds``
    rounds of the drift trace ``scenario`` over the TPU fleet (seed 0),
    as the reference's ``serve --plan --serve`` block does. Prints one
    line per round (with its B1 and B2 launches), the summary and, with
    ``plan_cache``, the cache's line; returns the ``ServiceReport``.
    ``mesh`` shards its solves."""
    trace = sample_trace(scenario, tpu_fleet_environment(), rounds=rounds,
                         seed=0)
    if traffic is not None:
        pso = dataclasses.replace(pso, miss_budget=traffic.miss_budget)
    scfg = ServiceConfig(
        replan=ReplanConfig(pso=pso, traffic=traffic, mesh=mesh),
        slo_s=slo_s,
        triage_margin=triage_margin, estimate_rates=estimate_rates,
        chaos=chaos_script(rounds) if chaos else None,
        plan_cache=PlanCacheConfig() if plan_cache else None,
        ingest=(IngestConfig(threads=async_ingest)
                if async_ingest is not None else None))

    def report(r, _plans) -> None:
        flags = "".join(f" [{f}]" for f, on in (
            ("solver-failed", r.solver_failed), ("stale-env", r.stale_env),
            ("stalled", r.stalled)) if on)
        print(f"[{prefix}] service round {r.round} ({r.label}): rungs "
              f"{list(r.rung)}, breaker {r.breaker_state}, "
              f"{r.wall_s * 1e3:.0f}ms{flags}, launches B1 "
              f"{schedule_replay.launches} B2 {traffic_replay.launches}",
              flush=True)
        schedule_replay.launches = traffic_replay.launches = 0

    schedule_replay.launches = traffic_replay.launches = 0
    rep = run_service([p.dag for p in plans], trace, scfg, seed=0,
                      initial=[p.result for p in plans], telemetry=telemetry,
                      device=device, on_round=report)
    s = rep.summary()
    ttp = s["time_to_plan_s"]
    print(f"[{prefix}] service: {s['rounds']} rounds, availability "
          f"{s['availability']:.4f}, time-to-plan p50 "
          f"{ttp['p50'] * 1e3:.0f}ms p99 {ttp['p99'] * 1e3:.0f}ms, "
          f"fallbacks {s['fallback_counts']}")
    if rep.cache_stats is not None:
        cs = rep.cache_stats
        n_look = cs["hits"] + cs["misses"]
        rate = cs["hits"] / n_look if n_look else 0.0
        print(f"[{prefix}] plan cache: hit rate {rate:.2f} "
              f"({cs['hits']}/{n_look}), stores {cs['stores']}, "
              f"evictions {cs['evictions']}, revalidation failures "
              f"{cs['revalidation_failures']}")
    return rep


def plan_from_args(cfg, args, *, device, prefix: str = "plan"):
    """Everything the planner's options ask for (``add_plan_args``): plan
    ``cfg``'s serving shapes, then re-plan (``--replan``) and serve them
    (``--serve``), under one telemetry channel installed globally for
    the planning path when ``--trace-out`` / ``--metrics-out`` is given,
    exported at the end; ``--mesh`` shards every solve. Returns the
    ``ServiceReport`` with ``--serve``, else None."""
    tel = Telemetry() if (args.trace_out or args.metrics_out) else None
    mesh = resolve_mesh(args.mesh, device=device)
    if mesh is not None:
        print(f"[{prefix}] solver mesh: "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{mesh.size()} devices")
    rep = None
    with telemetry_scope(tel):
        out = plan_serving_shapes(
            cfg, device=device, pop=args.pop, iters=args.iters,
            traffic=args.traffic, traffic_rate=args.traffic_rate,
            prefix=prefix, replan=args.replan,
            replan_rounds=args.replan_rounds, telemetry=tel, mesh=mesh)
        if args.serve_scenario:
            plans = out[0] if args.replan else out
            pso, tc = solver_configs(args.pop, args.iters, args.traffic,
                                     args.traffic_rate)
            rep = serve_plans(
                plans, args.serve_scenario, args.serve_rounds, pso, tc,
                device=device, chaos=args.chaos, slo_s=args.slo_s,
                triage_margin=args.triage_margin,
                estimate_rates=args.estimate_rates,
                plan_cache=args.plan_cache, async_ingest=args.async_ingest,
                telemetry=tel, prefix=prefix, mesh=mesh)
    if tel is not None:
        if args.trace_out:
            tel.export_trace(args.trace_out)
            n_ev = len(tel.tracer.to_chrome_trace()["traceEvents"])
            print(f"[{prefix}] telemetry: wrote {n_ev} trace events to "
                  f"{args.trace_out} (open in Perfetto / chrome://tracing)")
        if args.metrics_out:
            tel.export_metrics(args.metrics_out)
            print(f"[{prefix}] telemetry: wrote metrics snapshot to "
                  f"{args.metrics_out}/metrics.{{jsonl,prom}}")
    return rep


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
    ap.add_argument("--serve", default=None, metavar="SCENARIO",
                    dest="serve_scenario",
                    choices=TRACE_KINDS + TRAFFIC_KINDS,
                    help="run the fault-tolerant always-on planning "
                         "service on the plans over a drift trace of "
                         "this family (a traffic family serves that "
                         "request stream through a load-surge trace)")
    ap.add_argument("--serve-rounds", type=int, default=6,
                    help="rounds of the --serve trace, the cold one "
                         "included")
    ap.add_argument("--chaos", action="store_true",
                    help="with --serve: inject a solver crash, a NaN env "
                         "snapshot and a mid-round node loss")
    ap.add_argument("--slo-s", type=float, default=float("inf"),
                    help="per-round time-to-plan SLO of the --serve "
                         "watchdog (seconds)")
    ap.add_argument("--triage-margin", type=float, default=0.0,
                    help="with --serve --traffic: reject apps whose "
                         "deadline < margin x HEFT completion (0 disables)")
    ap.add_argument("--estimate-rates", action="store_true",
                    help="with --serve --traffic: plan on arrival rates "
                         "estimated from the observed stream")
    ap.add_argument("--plan-cache", action="store_true",
                    help="with --serve: serve repeat scenarios from the "
                         "plan cache through its replay-exact gate")
    ap.add_argument("--async-ingest", type=int, default=None,
                    metavar="THREADS",
                    help="with --serve --estimate-rates: queue the rate "
                         "observations; 0 = deterministic single-thread "
                         "mode, N > 0 = N producer threads")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write a Chrome trace-event JSON of the planning "
                         "spans (Perfetto / chrome://tracing)")
    ap.add_argument("--mesh", default="none",
                    choices=("none", "host", "prod"),
                    help="device mesh for the fleet solver: shard every "
                         "solve over the mesh's data axes. 'host' builds "
                         "the test mesh over the world's ranks; 'prod' "
                         "needs a world of 256. Plans are bit for bit "
                         "those of --mesh none.")
    ap.add_argument("--metrics-out", default=None, metavar="DIR",
                    help="write the telemetry registry snapshot "
                         "(metrics.jsonl + metrics.prom) to DIR")


def check_plan_args(ap: argparse.ArgumentParser, args) -> None:
    """The reference's rules for the shared planner options (it may set
    ``args.traffic``: ``--serve bursty`` means ``--traffic bursty``
    through a ``load-surge`` trace)."""
    if args.replan == "load-surge" and not args.traffic:
        ap.error("--replan load-surge drifts the request stream, which "
                 "only exists with --traffic SCENARIO")
    if args.replan_rounds < 1:
        ap.error("--replan-rounds must be >= 1")
    if args.serve_scenario in TRAFFIC_KINDS:
        if args.traffic and args.traffic != args.serve_scenario:
            ap.error(f"--serve {args.serve_scenario} conflicts with "
                     f"--traffic {args.traffic}: pick one arrival family")
        args.traffic = args.serve_scenario
        args.serve_scenario = "load-surge"
    if args.serve_scenario == "load-surge" and not args.traffic:
        ap.error("--serve load-surge drifts the request stream, which "
                 "only exists with --traffic SCENARIO")
    if args.serve_rounds < 1:
        ap.error("--serve-rounds must be >= 1")
    if (args.estimate_rates or args.triage_margin > 0.0) \
            and not args.traffic:
        ap.error("--estimate-rates / --triage-margin need --traffic (they "
                 "act on the request stream)")
    if args.async_ingest is not None and not args.estimate_rates:
        ap.error("--async-ingest needs --estimate-rates (it queues the "
                 "rate observations)")
    if args.async_ingest is not None and args.async_ingest < 0:
        ap.error("--async-ingest THREADS must be >= 0")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    add_plan_args(ap)
    args = ap.parse_args(argv)
    check_plan_args(ap, args)
    plan_from_args(get(args.arch), args, device=args.device)


if __name__ == "__main__":
    main()
