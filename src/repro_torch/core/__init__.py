"""The planner, ported: cost-driven offloading of DNN layers over cloud /
edge / end devices via PSO-GA (Lin et al., 2019).

Public surface of this slice:
  * LayerDAG / preprocess / merge_dags      — paper §III-A, Alg. 1
  * Environment / paper_environment / ...   — paper §III-A, Tables II-IV
  * SimProblem / simulate_np / pad_problem / simulate_swarm — paper Alg. 2
  * make_swarm_fitness / fitness_key        — paper Eq. 14-16
  * run_pso_ga / PSOGAConfig / swarm_step   — paper §IV (Eq. 17-23)
  * greedy_offload / heft_makespan          — paper §V-B competitors
  * run_pso_ga_batch / pack_fleet           — fleet-scale batched solver
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
from .fitness import (INFEASIBLE_OFFSET, fitness_key, make_swarm_fitness,
                      migration_cost)
from .pso_ga import (PSOGAConfig, PSOGAResult, SwarmDraws, draw_swarm,
                     init_swarm, run_pso_ga, state_from_arrays, swarm_step)
from .batch import (FleetBucket, PackedFleet, bucket_size, pack_fleet,
                    pack_problems, run_pso_ga_batch)
from .seeding import coerce_seed, rng_entropy
from .baselines import greedy_offload, heft_makespan
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
    "INFEASIBLE_OFFSET", "fitness_key", "make_swarm_fitness",
    "migration_cost",
    "PSOGAConfig", "PSOGAResult", "SwarmDraws", "draw_swarm", "init_swarm",
    "run_pso_ga", "state_from_arrays", "swarm_step",
    "FleetBucket", "PackedFleet", "bucket_size", "pack_fleet",
    "pack_problems", "run_pso_ga_batch",
    "coerce_seed", "rng_entropy",
    "greedy_offload", "heft_makespan",
    "Stage", "contiguous_stages", "stage_cut_cost", "uniform_stages",
    "OffloadPlan", "arch_to_dag", "block_flops", "plan_offload",
    "plan_offload_batch", "zoo",
]
