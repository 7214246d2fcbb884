"""The port's non-traffic swarm fitness against the reference: the 3-case
key (Eq. 14–16), the migration term, and the stacked fleet form."""
import jax
import numpy as np
import pytest
import torch
from test_torch_parity import CPU, RTOL, link_aware_swarm, np_of, to_port

import repro.core as ref
import repro_torch.core as port

torch.set_num_threads(1)


def _problem(net, ratio):
    env = ref.paper_environment()
    dag = ref.zoo.build(net, pin_server=2)
    h, _ = ref.heft_makespan(dag, env)
    return ref.SimProblem.build(dag.with_deadline(np.array([ratio * h])),
                                env)


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("net", ["alexnet", "googlenet"])
def test_keys_match_reference_with_migration(net, faithful):
    """Cold keys, and warm keys with an incumbent and a migration weight,
    agree with the reference's scan backend on feasible and infeasible
    particles alike."""
    prob = _problem(net, 2.0)
    pp_ref = ref.pad_problem(prob, max_p=prob.num_layers + 6, max_S=32)
    pp = to_port(pp_ref)
    rng = np.random.default_rng(3)
    X = link_aware_swarm(rng, prob, 10, pp.max_layers)
    inc = X[0]
    for kwargs in ({}, {"incumbent": inc, "mig_weight": 0.7}):
        want = np.asarray(jax.jit(ref.make_swarm_fitness(
            pp_ref, faithful, "scan", **kwargs))(X))
        got = np_of(port.make_swarm_fitness(pp, faithful, **{
            k: torch.as_tensor(v) for k, v in kwargs.items()})(
                torch.as_tensor(X)))
        assert (got < port.INFEASIBLE_OFFSET).any()
        assert (got >= port.INFEASIBLE_OFFSET).any()
        np.testing.assert_array_equal(got < port.INFEASIBLE_OFFSET,
                                      want < ref.INFEASIBLE_OFFSET)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    mig_want = np.asarray(ref.migration_cost(pp_ref, X, inc))
    mig_got = np_of(port.migration_cost(pp, torch.as_tensor(X),
                                        torch.as_tensor(inc)))
    assert mig_got[1:].max() > 0 and mig_got[0] == 0
    np.testing.assert_allclose(mig_got, mig_want, rtol=RTOL)


def test_stacked_fitness_equals_per_problem():
    """One call on a stacked fleet (per-problem incumbents and weights)
    equals each problem's own fitness."""
    probs = [_problem(net, r) for net, r in (("alexnet", 1.5),
                                             ("vgg19", 3.0))]
    pps = [port.pad_problem(pr, max_p=32, max_S=32, max_in=1, max_out=1,
                            device=CPU) for pr in probs]
    rng = np.random.default_rng(4)
    Xb = np.stack([link_aware_swarm(rng, pr, 6, 32) for pr in probs])
    inc = Xb[:, 1]
    w = np.array([0.5, 2.0], np.float32)
    fleet = np_of(port.make_swarm_fitness(
        port.stack_problems(pps), False, incumbent=torch.as_tensor(inc),
        mig_weight=torch.as_tensor(w))(torch.as_tensor(Xb)))
    for n, pp in enumerate(pps):
        alone = np_of(port.make_swarm_fitness(
            pp, False, incumbent=torch.as_tensor(inc[n]),
            mig_weight=float(w[n]))(torch.as_tensor(Xb[n])))
        np.testing.assert_array_equal(fleet[n], alone)


def test_fitness_key_matches_reference():
    prob = _problem("vgg19", 2.0)
    rng = np.random.default_rng(8)
    X = link_aware_swarm(rng, prob, 6, prob.num_layers)
    sim_ref = jax.jit(ref.build_simulator(prob, faithful=False))
    sim = port.build_simulator(prob, faithful=False, device=CPU)
    for x in X:
        np.testing.assert_allclose(
            float(port.fitness_key(sim(torch.as_tensor(x)))),
            float(ref.fitness_key(sim_ref(x))), rtol=RTOL)
