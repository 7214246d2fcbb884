"""PSO-GA in the port against the reference: one step fed the reference's
own draws, whole solves reproducing the non-traffic goldens of
``tests/golden_costs.json``, plus the port's own initialization, draw
and device rules."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_parity import (CPU, RTOL, RefDraws, legacy_stream, np_of,
                               port_cfg, ref_step_draws, to_port)

import repro.core as ref
import repro_torch.core as port
from repro.core.pso_ga import _SwarmState as RefState
from repro.core.pso_ga import init_swarm as ref_init_swarm
from repro.core.pso_ga import swarm_step as ref_swarm_step

torch.set_num_threads(1)

GOLDENS = json.loads(
    (Path(__file__).parent / "golden_costs.json").read_text())
_CFG = GOLDENS["_config"]


def _deadlined(lib, net, ratio, n_devices=1):
    env = lib.paper_environment()
    dag = lib.merge_dags([lib.zoo.build(net, pin_server=d)
                          for d in range(n_devices)])
    h, _ = lib.heft_makespan(dag, env)
    return dag.with_deadline(np.full(dag.num_apps, ratio * h)), env


@pytest.mark.parametrize("faithful", [False, True])
def test_swarm_step_fed_reference_draws_matches_gene_for_gene(faithful):
    """The draws adapter: the reference's draws fed to the port's
    ``swarm_step`` give the reference step's X, pBest and gBest, gene for
    gene, over several steps on a padded two-app problem."""
    dag, env = _deadlined(ref, "alexnet", 2.0, n_devices=2)
    prob = ref.SimProblem.build(dag, env)
    cfg_ref = ref.PSOGAConfig(pop_size=12, max_iters=40, faithful_sim=faithful)
    cfg = port_cfg(cfg_ref)
    pp_ref = ref.pad_problem(prob, max_p=32, max_S=32)
    pp = to_port(pp_ref)
    step_ref = jax.jit(lambda pp_, st: ref_swarm_step(pp_, st, cfg_ref))
    with legacy_stream():
        key, k_init = jax.random.split(jax.random.PRNGKey(5))
        X0 = np.zeros((12, 32), np.int32)
        X0[:, :prob.num_layers] = ref_init_swarm(k_init, prob, cfg_ref)
        f0 = ref.make_swarm_fitness(pp_ref, faithful)(X0)
        i0 = int(np.argmin(f0))
        st_ref = RefState(key=key, X=X0, pbest_x=X0, pbest_f=f0,
                          gbest_x=X0[i0], gbest_f=f0[i0],
                          it=np.int32(0), stall=np.int32(0))
    st = port.state_from_arrays(st_ref, device=CPU)
    f0 = np_of(st.pbest_f)
    for _ in range(8):
        with legacy_stream():
            _, draws = ref_step_draws(st_ref.key, 12, prob.num_layers,
                                      prob.num_servers)
            st_ref = step_ref(pp_ref, st_ref)
        st = port.swarm_step(pp, st, cfg, draws=port.SwarmDraws(
            *(torch.tensor(d) for d in draws)))
        for field in ("X", "pbest_x", "gbest_x", "it", "stall"):
            np.testing.assert_array_equal(np_of(getattr(st, field)),
                                          np.asarray(getattr(st_ref, field)),
                                          err_msg=field)
        np.testing.assert_allclose(np_of(st.pbest_f),
                                   np.asarray(st_ref.pbest_f), rtol=RTOL)
    assert (np_of(st.pbest_f) < f0).any()     # the steps moved the swarm
    assert (np_of(st.X)[:, prob.num_layers:] == 0).all()   # padding inert


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("net", ref.zoo.NAMES)
def test_golden_costs_with_reference_draws(net, faithful):
    """``run_pso_ga`` fed the reference's initial swarm and step draws
    reproduces the reference's pinned end-to-end results."""
    want = GOLDENS[f"{net}|faithful={faithful}|scan"]
    dag, env = _deadlined(port, net, _CFG["deadline_ratio"])
    rdag, renv = _deadlined(ref, net, _CFG["deadline_ratio"])
    cfg_ref = ref.PSOGAConfig(pop_size=_CFG["pop_size"],
                              max_iters=_CFG["max_iters"],
                              stall_iters=_CFG["stall_iters"],
                              faithful_sim=faithful)
    draws = RefDraws([ref.SimProblem.build(rdag, renv)], cfg_ref,
                     [_CFG["seed"]])
    res = port.run_pso_ga(dag, env, port_cfg(cfg_ref), device=CPU,
                          X0=draws.X0[0], draw_fn=draws)
    assert res.feasible == want["feasible"]
    assert res.iterations == want["iterations"]
    np.testing.assert_allclose(res.best_fitness, want["best_fitness"],
                               rtol=RTOL)
    np.testing.assert_allclose(res.best_cost, want["best_cost"], rtol=RTOL)


def test_init_swarm_link_aware_with_anchors():
    dag, env = _deadlined(port, "alexnet", 2.0, n_devices=3)
    prob = port.SimProblem.build(dag, env)
    cfg = port.PSOGAConfig(pop_size=40)
    g = torch.Generator().manual_seed(0)
    X = np_of(port.init_swarm(prob, cfg, g, device=CPU))
    assert X.shape == (40, prob.num_layers) and X.dtype == np.int32
    pinned = prob.pinned >= 0
    assert (X[:, pinned] == prob.pinned[pinned]).all()
    home = np.repeat([0, 1, 2], dag.num_layers // 3)
    assert (X[0] == home).all()                         # all-home anchor
    for k in range(prob.num_servers):                   # S single-server
        assert (X[1 + k][~pinned] == k).all()
    rand = X[prob.num_servers + 1:]
    reach = prob.link_ok[home] | (np.arange(prob.num_servers) == home[:,
                                                                      None])
    assert reach[np.arange(prob.num_layers), rand].all()
    X2 = np_of(port.init_swarm(prob, cfg, torch.Generator().manual_seed(0),
                               device=CPU))
    np.testing.assert_array_equal(X, X2)


def test_draws_stay_inside_true_sizes():
    u = torch.tensor([[0.0] * 9, [1.0 - 2 ** -24] * 9])
    d = port.pso_ga.draws_from_uniforms(u, torch.tensor(10140),
                                        torch.tensor(20))
    assert d.pos.tolist() == [0, 10139] and d.val.tolist() == [0, 19]
    assert d.seg1.tolist() == [[0, 0], [10139, 10139]]


def test_history_and_seeded_determinism():
    dag, env = _deadlined(port, "vgg19", 2.0)
    cfg = port.PSOGAConfig(pop_size=8, max_iters=12, stall_iters=3)
    a = port.run_pso_ga(dag, env, cfg, seed=3, device=CPU)
    b = port.run_pso_ga(dag, env, cfg, seed=3, device=CPU)
    assert a.iterations == b.iterations and a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_x, b.best_x)
    h = port.run_pso_ga(dag, env, cfg, seed=3, device=CPU,
                        record_history=True)
    assert h.iterations == cfg.max_iters and h.history.shape == (12,)
    assert (np.diff(h.history) <= 0).all()
    assert h.best_fitness == h.history[-1]


def test_entry_points_raise_without_a_card(monkeypatch):
    """Nothing falls back to the CPU unless asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dag, env = _deadlined(port, "alexnet", 2.0)
    cfg = port.PSOGAConfig(pop_size=4, max_iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.run_pso_ga(dag, env, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.run_pso_ga_batch([(dag, env)], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.pad_problem(port.SimProblem.build(dag, env))
    assert port.run_pso_ga(dag, env, cfg, device="cpu").iterations == 2
