"""The planner, ported: cost-driven offloading of DNN layers over cloud /
edge / end devices via PSO-GA (Lin et al., 2019).

Public surface:
  * LayerDAG / preprocess / merge_dags      — paper §III-A, Alg. 1
  * Environment / paper_environment / ...   — paper §III-A, Tables II-IV
  * SimProblem / simulate_np / pad_problem / simulate_swarm — paper Alg. 2
  * make_swarm_fitness / fitness_key        — paper Eq. 14-16 (+ traffic key)
  * sample_arrivals / TrafficConfig / simulate_traffic_swarm /
    traffic_replay / traffic_stats          — queue-aware planning
  * run_pso_ga / PSOGAConfig / swarm_step / init_swarm
                                            — paper §IV (Eq. 17-23), cold
                                              and incumbent-seeded
  * greedy_offload / heft_makespan / run_ga / GAConfig / run_pso_linear /
    pre_pso                                 — paper §V-B competitors
  * run_pso_ga_batch / pack_fleet           — fleet-scale batched solver
                                              (cold and warm)
  * EnvTrace / DriftEvent / sample_trace / zero_drift_trace /
    ReplanConfig / replan_round / replan_fleet / incumbent_keys /
    plan_is_valid                           — online re-planning
  * ServiceConfig / ChaosConfig / run_service / run_services /
    LADDER_RUNGS                            — fault-tolerant always-on
                                              planning service
  * PlanCache / PlanCacheConfig / dag_fingerprint — the service's plan
                                              cache
  * IngestConfig / ArrivalQueue             — async arrival ingestion
  * Telemetry / MetricsRegistry / SpanTracer — unified metrics + span
                                              tracing
  * placement / partition                   — the model-fleet bridge
  * zoo                                     — AlexNet/VGG19/GoogleNet/ResNet101
"""
from .dag import LayerDAG, merge_dags, preprocess, topological_order
from .device import backend_name, resolve_device
from .environment import (CLOUD, DEVICE, EDGE, Environment,
                          paper_environment, sample_environment,
                          tpu_fleet_environment)
from .simulator import (PaddedProblem, SimProblem, SimResult,
                        build_simulator, pad_problem, padded_from_arrays,
                        simulate_np, simulate_padded, simulate_swarm,
                        stack_problems)
from .traffic import (TRAFFIC_KINDS, ArrivalQueue, ArrivalTrace,
                      IngestConfig, MergedOrder, TrafficConfig, TrafficInputs,
                      TrafficResult, TrafficSim, merged_order,
                      percentile_linear, sample_arrivals,
                      simulate_traffic_swarm, traffic_inputs, traffic_replay,
                      traffic_stats, zero_contention_arrivals)
from .telemetry import (MetricsRegistry, SpanTracer, Telemetry,
                        get_telemetry, maybe_span, set_telemetry,
                        telemetry_scope)
from .fitness import (INFEASIBLE_OFFSET, MISS_PENALTY, fitness_key,
                      make_swarm_fitness, migration_cost)
from .pso_ga import (PSOGAConfig, PSOGAResult, SwarmDraws, draw_swarm,
                     init_swarm, run_pso_ga, state_from_arrays, swarm_step)
from .batch import (FleetBucket, PackedFleet, bucket_size, pack_arrivals,
                    pack_fleet, pack_problems, run_pso_ga_batch)
from .seeding import coerce_seed, rng_entropy
from .baselines import (GAConfig, GADraws, greedy_offload, heft_makespan,
                        pre_pso, run_ga, run_pso_linear)
from .online import (TRACE_KINDS, DriftEvent, EnvTrace, OnlineReport,
                     ReplanConfig, RoundLog, incumbent_keys,
                     migration_cost_np, plan_is_valid, replan_fleet,
                     replan_round, sample_trace, zero_drift_trace)
from .plancache import PlanCache, PlanCacheConfig, dag_fingerprint
from .service import (LADDER_RUNGS, ChaosConfig, ServiceConfig,
                      ServiceReport, ServiceRoundLog, run_service,
                      run_services)
from .partition import Stage, contiguous_stages, stage_cut_cost, \
    uniform_stages
from .placement import (OffloadPlan, arch_to_dag, block_flops, plan_offload,
                        plan_offload_batch)
from . import zoo

__all__ = [
    "LayerDAG", "merge_dags", "preprocess", "topological_order",
    "backend_name", "resolve_device",
    "Environment", "paper_environment", "sample_environment",
    "tpu_fleet_environment", "CLOUD", "EDGE", "DEVICE",
    "SimProblem", "SimResult", "build_simulator", "simulate_np",
    "PaddedProblem", "pad_problem", "padded_from_arrays", "simulate_padded",
    "simulate_swarm", "stack_problems",
    "TRAFFIC_KINDS", "ArrivalTrace", "MergedOrder", "TrafficConfig",
    "TrafficInputs", "TrafficResult", "TrafficSim", "merged_order",
    "percentile_linear", "sample_arrivals", "simulate_traffic_swarm",
    "traffic_inputs", "traffic_replay", "traffic_stats",
    "zero_contention_arrivals",
    "INFEASIBLE_OFFSET", "MISS_PENALTY", "fitness_key", "make_swarm_fitness",
    "migration_cost",
    "PSOGAConfig", "PSOGAResult", "SwarmDraws", "draw_swarm", "init_swarm",
    "run_pso_ga", "state_from_arrays", "swarm_step",
    "FleetBucket", "PackedFleet", "bucket_size", "pack_arrivals",
    "pack_fleet", "pack_problems", "run_pso_ga_batch",
    "coerce_seed", "rng_entropy",
    "greedy_offload", "heft_makespan", "GAConfig", "GADraws", "run_ga",
    "run_pso_linear", "pre_pso",
    "TRACE_KINDS", "DriftEvent", "EnvTrace", "OnlineReport", "ReplanConfig",
    "RoundLog", "incumbent_keys", "migration_cost_np", "plan_is_valid",
    "replan_fleet", "replan_round", "sample_trace", "zero_drift_trace",
    "ChaosConfig", "LADDER_RUNGS", "ServiceConfig", "ServiceReport",
    "ServiceRoundLog", "run_service", "run_services",
    "PlanCache", "PlanCacheConfig", "dag_fingerprint",
    "MetricsRegistry", "SpanTracer", "Telemetry", "get_telemetry",
    "maybe_span", "set_telemetry", "telemetry_scope",
    "ArrivalQueue", "IngestConfig",
    "Stage", "contiguous_stages", "stage_cut_cost", "uniform_stages",
    "OffloadPlan", "arch_to_dag", "block_flops", "plan_offload",
    "plan_offload_batch", "zoo",
]
