"""The replay kernel's plain PyTorch version against the reference's
oracle (``ref.schedule_replay_ref``) and Pallas kernel (interpret mode),
its fleet axis against a per-problem loop, and the wrapper's device
routing. The CUDA kernel itself is checked on a card by
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
from test_simulator import random_dag, random_env
from test_torch_parity import CPU, RTOL, np_of, to_port

import repro.core as ref
from repro.kernels.ref import schedule_replay_ref
from repro.kernels.schedule_sim import schedule_replay_folded
from repro_torch.core import pad_problem, stack_problems
from repro_torch.core.simulator import SimProblem, kernel_args
from repro_torch.kernels import schedule_sim

torch.set_num_threads(1)


def _random_problem(seed, p, s, n_apps):
    rng = np.random.default_rng(seed)
    return ref.SimProblem.build(random_dag(rng, p, n_apps=n_apps),
                                random_env(rng, s)), rng


def _ref_fields(pp):
    return (pp.order, pp.compute, pp.parent_idx, pp.parent_mb, pp.child_idx,
            pp.child_mb, pp.app_id, pp.deadline, pp.pinned, pp.power,
            pp.cost_per_sec, pp.inv_bw, pp.tran_cost, pp.link_ok)


def _swarm(rng, P, p, s, max_p):
    X = np.zeros((P, max_p), np.int32)
    X[:, :p] = rng.integers(0, s, size=(P, p))
    return X


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_ref_and_pallas(seed, faithful):
    """Plain version == reference oracle == Pallas kernel (interpret) on
    loosely padded random problems, including padded apps and servers."""
    prob, rng = _random_problem(seed, p=10 + seed, s=4, n_apps=1 + seed)
    pp_ref = ref.pad_problem(prob, max_p=16, max_S=8, max_apps=4)
    X = _swarm(rng, 7, prob.num_layers, prob.num_servers, 16)
    want = schedule_replay_ref(*_ref_fields(pp_ref), X, faithful=faithful)
    pallas = schedule_replay_folded(*_ref_fields(pp_ref), X,
                                    faithful=faithful, tile_p=4,
                                    interpret=True)
    got = schedule_sim.schedule_replay_plain(
        *kernel_args(to_port(pp_ref)), torch.as_tensor(X)[None],
        faithful=faithful)
    got = [np_of(o[0]) for o in got]
    for other in (want, pallas):
        np.testing.assert_allclose(got[0], np.asarray(other[0]), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[1], np.asarray(other[1]))
        np.testing.assert_allclose(got[2], np.asarray(other[2]), rtol=RTOL)


@pytest.mark.parametrize("faithful", [True, False])
def test_fleet_axis_equals_per_problem_loop(faithful):
    """A stacked fleet replays exactly as each problem alone, padded to
    the fleet's shape (bit-identical: padding adds exact zeros)."""
    rng = np.random.default_rng(5)
    probs = [SimProblem.build(random_dag(rng, p, n_apps=a),
                              random_env(rng, s))
             for p, s, a in ((6, 3, 1), (13, 5, 2), (9, 4, 3))]
    sizes = dict(max_p=16, max_S=8, max_in=3, max_out=8, max_apps=3)
    ppb = stack_problems([pad_problem(pr, device=CPU, **sizes)
                          for pr in probs])
    Xb = np.stack([_swarm(rng, 5, pr.num_layers, pr.num_servers, 16)
                   for pr in probs])
    fleet = schedule_sim.schedule_replay_plain(
        *kernel_args(ppb), torch.as_tensor(Xb), faithful=faithful)
    for n, pr in enumerate(probs):
        alone = schedule_sim.schedule_replay_plain(
            *kernel_args(pad_problem(pr, device=CPU)),
            torch.as_tensor(Xb[n:n + 1, :, :pr.num_layers]),
            faithful=faithful)
        for a, b in zip(fleet, alone):
            np.testing.assert_array_equal(np_of(a[n]), np_of(b[0]))


def test_wrapper_routes_cpu_to_plain_and_rejects_other_devices():
    prob, rng = _random_problem(3, p=8, s=3, n_apps=1)
    args = kernel_args(to_port(ref.pad_problem(prob)))
    X = torch.as_tensor(_swarm(rng, 4, 8, 3, 8))[None]
    before = schedule_sim.schedule_replay.launches
    got = schedule_sim.schedule_replay(*args, X)
    want = schedule_sim.schedule_replay_plain(*args, X)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert schedule_sim.schedule_replay.launches == before   # no kernel
    with pytest.raises(ValueError):
        schedule_sim.schedule_replay(*args, X.to("meta"))

