"""The replay kernel's plain PyTorch version against the reference's
oracle (``ref.schedule_replay_ref``) and Pallas kernel (interpret mode),
its fleet axis against a per-problem loop, the wrapper's device routing,
and the kernel's walk: its step tables and a plain emulation of its ring
and far-read addressing. The CUDA kernel itself is checked on a card by
``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
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



# ---------------------------------------------------------------------------
# the kernel's walk: step tables and ring addressing, emulated on the CPU
# ---------------------------------------------------------------------------

def _skip_dag():
    """A chain of 50 layers with long skip edges (0 -> 49, 3 -> 40,
    10 -> 45) and two apps: parents up to 49 steps back."""
    n = 50
    edges = [(j, j + 1) for j in range(n - 1)] + [(0, 49), (3, 40), (10, 45)]
    return ref.LayerDAG(compute=np.linspace(0.5, 2.0, n),
                        edges=np.asarray(edges, np.int32),
                        edge_mb=np.linspace(0.1, 1.5, len(edges)),
                        app_id=(np.arange(n) >= 30).astype(np.int32),
                        deadline=np.array([20.0, 40.0]),
                        pinned=np.r_[0, np.full(n - 1, -1)].astype(np.int32))


def _tables_problem(name):
    env = ref.paper_environment()
    dag = _skip_dag() if name == "skip" else ref.zoo.build(name)
    return ref.SimProblem.build(dag, env)


@pytest.mark.parametrize("ring", [2, 4, schedule_sim.RING])
@pytest.mark.parametrize("name", ["skip", "googlenet"])
def test_step_tables_distances_and_far_reads(name, ring):
    """Each parent's step distance, the "read beyond the ring" bit and the
    app of every step, and each tile's "reads beyond the ring" and "all
    real" bits, against a direct walk of the padded problem's order; the
    step axis is padded with no-op steps to whole tiles."""
    prob = _tables_problem(name)
    pp = ref.pad_problem(prob, max_p=prob.num_layers + 3)
    order = np.array(pp.order)
    pidx = np.array(pp.parent_idx)
    tile = ring // 2
    meta = np_of(schedule_sim.step_tables(
        torch.as_tensor(order)[None], torch.as_tensor(pidx)[None],
        torch.as_tensor(np.array(pp.app_id))[None], ring=ring,
        tile=tile))[0]
    assert meta.shape == (-(-len(order) // tile) * tile, 1 + pidx.shape[1])
    pos = {int(j): t for t, j in enumerate(order) if j >= 0}
    want = np.zeros_like(meta)
    read_far = set()
    for t, j in enumerate(order):
        if j < 0:
            continue
        for k, pj in enumerate(pidx[j]):
            if pj >= 0:
                want[t, 1 + k] = t - pos[int(pj)]
                if want[t, 1 + k] > ring:
                    read_far.add(pos[int(pj)])
    for t, j in enumerate(order):
        if j >= 0:
            want[t, 0] = 1 | (2 * (t in read_far)) | (
                int(np.asarray(pp.app_id)[j]) << 8)
    for t0 in range(0, len(want), tile):           # the tiles' own bits
        rows = want[t0:t0 + tile]
        want[t0, 0] |= 4 * bool((rows[:, 1:] > ring).any()) \
            | 8 * bool((rows[:, 0] & 1).all())
    np.testing.assert_array_equal(meta, want)
    far = want[:, 1:] > ring
    # googlenet's parents reach 7 steps back, the skip DAG's 49
    assert want[:, 1:].max() == (49 if name == "skip" else 7)
    assert far.any() == (ring < want[:, 1:].max())


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("ring,tile,ahead", [
    (2, 1, 1), (4, 1, 3), (8, 2, 3),
    (schedule_sim.RING, schedule_sim.TILE, schedule_sim.AHEAD)])
def test_ring_walk_equals_plain_and_reference(ring, tile, ahead, faithful):
    """The walk's ring and far-read addressing (``replay_ring_plain``), far
    reads copied ``ahead`` tiles early, on
    a stacked bucket of the skip DAG, googlenet and a random DAG of
    different true sizes, P = 37: bit for bit the plain replay, and the
    reference's scan (``simulate_swarm``) and Pallas kernel (jitted,
    interpret mode) per problem, ``feasible`` exactly and the sums to
    rtol 1e-5 (the reference adds transmission $ edge by edge, the port
    step by step). A ring of 2 sends most corrected-mode parents through
    the far route."""
    rng = np.random.default_rng(7)
    probs = [_tables_problem("skip"), _tables_problem("googlenet"),
             _random_problem(4, p=40, s=5, n_apps=3)[0]]
    own = [ref.pad_problem(pr) for pr in probs]
    max_in = max(pp.parent_idx.shape[1] for pp in own)
    max_out = max(pp.child_idx.shape[1] for pp in own)
    pps = [ref.pad_problem(pr, max_p=96, max_S=20, max_in=max_in,
                           max_out=max_out, max_apps=3) for pr in probs]
    ppb = stack_problems([to_port(pp) for pp in pps])
    X = np.stack([_swarm(rng, 37, pr.num_layers, pr.num_servers, 96)
                  for pr in probs])
    X[:, :9] = 0                                  # the pinned server: feasible
    Xt = torch.as_tensor(X)
    got = schedule_sim.replay_ring_plain(*kernel_args(ppb), Xt,
                                         faithful=faithful, ring=ring,
                                         tile=tile, ahead=ahead)
    plain = schedule_sim.schedule_replay_plain(*kernel_args(ppb), Xt,
                                               faithful=faithful)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert got[1].any() and not got[1].all()
    pallas = jax.jit(lambda pp, x: schedule_replay_folded(
        *_ref_fields(pp), x, faithful=faithful, tile_p=8, interpret=True))
    for n, pp in enumerate(pps):
        for other in (ref.simulate_swarm(pp, jnp.asarray(X[n]), faithful),
                      pallas(pp, jnp.asarray(X[n]))):
            np.testing.assert_array_equal(np_of(got[1][n]),
                                          np.asarray(other[1]))
            for k in (0, 2):
                np.testing.assert_allclose(np_of(got[k][n]),
                                           np.asarray(other[k]), rtol=RTOL)


def test_ring_walk_refuses_a_ring_shorter_than_its_copies_reach():
    prob, rng = _random_problem(3, p=8, s=3, n_apps=1)
    args = kernel_args(to_port(ref.pad_problem(prob)))
    X = torch.as_tensor(_swarm(rng, 4, 8, 3, 8))[None]
    with pytest.raises(ValueError, match="must hold 4 tiles"):
        schedule_sim.replay_ring_plain(*args, X, faithful=False, ring=8,
                                       tile=3, ahead=3)
