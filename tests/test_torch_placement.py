"""The port's planner front end: architecture lowering, baselines and
plans against the reference, and the plan CLI without JAX."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core as ref
import repro_torch.configs as port_configs
import repro_torch.core as port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("arch", ref_configs.names())
def test_arch_to_dag_matches_reference(arch):
    assert port_configs.get(arch) == port_configs.ARCHS[arch]
    for shape_r, shape_p in zip(ref_configs.SHAPES, port_configs.SHAPES):
        a = ref.arch_to_dag(ref_configs.get(arch), shape_r, pin_server=5)
        b = port.arch_to_dag(port_configs.get(arch), shape_p, pin_server=5)
        for field in ("compute", "edges", "edge_mb", "app_id", "pinned",
                      "deadline"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert a.names == b.names


@pytest.mark.parametrize("net", ["googlenet", "resnet101"])
def test_heft_and_greedy_match_reference(net):
    env_r, env_p = ref.paper_environment(), port.paper_environment()
    dag_r = ref.merge_dags([ref.zoo.build(net, pin_server=d)
                            for d in range(2)])
    dag_p = port.merge_dags([port.zoo.build(net, pin_server=d)
                             for d in range(2)])
    hr, xr = ref.heft_makespan(dag_r, env_r)
    hp, xp = port.heft_makespan(dag_p, env_p)
    assert hr == hp
    np.testing.assert_array_equal(xr, xp)
    for faithful in (False, True):
        dr = dag_r.with_deadline(np.full(2, 1.5 * hr))
        dp = dag_p.with_deadline(np.full(2, 1.5 * hp))
        gr = ref.greedy_offload(dr, env_r, faithful=faithful)
        gp = port.greedy_offload(dp, env_p, faithful=faithful)
        np.testing.assert_array_equal(gr.best_x, gp.best_x)
        assert (gr.best_cost, gr.feasible) == (gp.best_cost, gp.feasible)


def test_plan_offload_batch_on_cpu():
    """Serving shapes of one arch planned as one fleet: each plan replays
    exactly to its reported cost, and greedy plans equal the reference."""
    cfg = port_configs.get("qwen3-0.6b")
    shapes = [s for s in port_configs.SHAPES if s.kind != "train"]
    pso = port.PSOGAConfig(pop_size=12, max_iters=15, stall_iters=5)
    plans = port.plan_offload_batch([(cfg, s, 1.5) for s in shapes],
                                    pso=pso, device="cpu")
    assert [p.backend for p in plans] == ["cpu"] * len(shapes)
    for plan in plans:
        replay = port.simulate_np(port.SimProblem.build(plan.dag, plan.env),
                                  plan.result.best_x, faithful=pso.faithful_sim)
        assert bool(replay.feasible) == plan.result.feasible
        if plan.result.feasible:
            np.testing.assert_allclose(plan.cost, float(replay.total_cost),
                                       rtol=1e-5)
        assert sum(len(st.layers) for st in plan.stages) == plan.dag.num_layers
        assert "backend=cpu" in plan.summary()
    g_ref = ref.plan_offload(ref_configs.get("qwen3-0.6b"),
                             ref_configs.SHAPES[1], algo="greedy")
    g_port = port.plan_offload(cfg, shapes[0], algo="greedy", device="cpu")
    np.testing.assert_array_equal(g_ref.result.best_x, g_port.result.best_x)
    assert (g_ref.deadline, g_ref.heft) == (g_port.deadline, g_port.heft)


def test_plan_cli_runs_without_jax():
    code = ("import runpy, sys; "
            "sys.argv = ['plan', '--arch', 'qwen3-0.6b', '--device', 'cpu', "
            "'--pop', '6', '--iters', '4']; "
            "runpy.run_module('repro_torch.launch.plan', run_name='__main__');"
            " print('JAX_LOADED', 'jax' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_LOADED False" in out.stdout
    assert out.stdout.count("backend=cpu") == 6     # header + summary, ×3
