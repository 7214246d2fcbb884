"""Parity between the PyTorch port (``repro_torch``) and the JAX reference
(``repro``): shared helpers for every ``test_torch_*`` file, plus the
problem-data checks (zoo DAGs, environments, ``SimProblem`` arrays).

Both packages get identical inputs: problems and swarms are built with
numpy and converted with the port's ``padded_from_arrays`` /
``state_from_arrays``. Random draws come from the reference's own
``jax.random`` calls, made under a SCOPED ``jax.threefry_partitionable
(False)`` (the stream ``tests/golden_costs.json`` was generated with), and
are handed to the port's ``draw_fn`` hook. Tolerances: integers and
booleans exact; float32 costs and keys rtol 1e-5, because the two
packages take their sums in different orders.
"""
import contextlib
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.pso_ga import init_swarm as ref_init_swarm

torch.set_num_threads(1)

RTOL = 1e-5
CPU = "cpu"


@contextlib.contextmanager
def legacy_stream():
    """The reference's RNG stream as the goldens were drawn, scoped so no
    other JAX test in the same worker sees the switch."""
    with jax.threefry_partitionable(False):
        yield


def to_port(pp_ref) -> port.PaddedProblem:
    """A reference ``PaddedProblem`` as the port's CPU tensors."""
    return port.padded_from_arrays(pp_ref, device=CPU)


def np_of(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def ref_step_draws(key, P: int, p: int, s: int):
    """The draws the reference ``swarm_step`` makes from ``key``
    (``pso_ga.py:225-257``): returns (next key, ``port.SwarmDraws``)."""
    key, kmu, kmu_pos, kmu_val, kc1, kx1, kc2, kx2 = jax.random.split(key, 8)
    p = jnp.asarray(p, jnp.int32)
    s = jnp.asarray(s, jnp.int32)
    draws = port.SwarmDraws(
        do_mu=jax.random.uniform(kmu, (P,)),
        pos=jax.random.randint(kmu_pos, (P,), 0, p),
        val=jax.random.randint(kmu_val, (P,), 0, s, dtype=jnp.int32),
        c1=jax.random.uniform(kc1, (P,)),
        seg1=jax.random.randint(kx1, (P, 2), 0, p),
        c2=jax.random.uniform(kc2, (P,)),
        seg2=jax.random.randint(kx2, (P, 2), 0, p))
    return key, port.SwarmDraws(*(np.asarray(d) for d in draws))


class RefDraws:
    """Feeds each problem the reference's own stream: seeded exactly like
    ``run_pso_ga`` (``key, k_init = split(PRNGKey(seed))``), initial
    swarm from the reference ``init_swarm``, then one ``ref_step_draws``
    per step. Usable as ``draw_fn`` of ``run_pso_ga[_batch]``."""

    def __init__(self, probs: List, cfg_ref, seeds: List[int]):
        self.probs, self.cfg = probs, cfg_ref
        self.keys: Dict[int, jax.Array] = {}
        self.X0 = []
        with legacy_stream():
            for i, (pr, seed) in enumerate(zip(probs, seeds)):
                key, k_init = jax.random.split(jax.random.PRNGKey(seed))
                self.keys[i] = key
                self.X0.append(np.asarray(ref_init_swarm(k_init, pr,
                                                         cfg_ref)))

    def __call__(self, i: int, step: int) -> port.SwarmDraws:
        pr = self.probs[i]
        with legacy_stream():
            self.keys[i], draws = ref_step_draws(
                self.keys[i], self.cfg.pop_size, pr.num_layers,
                pr.num_servers)
        return draws


def port_cfg(cfg_ref) -> port.PSOGAConfig:
    """The port's config with the reference config's shared fields."""
    names = [f.name for f in port.PSOGAConfig.__dataclass_fields__.values()]
    return port.PSOGAConfig(**{n: getattr(cfg_ref, n) for n in names})


def link_aware_swarm(rng, prob, P: int, max_p: int, frac: float = 0.5):
    """A numpy swarm: ``frac`` of the particles drawn over each layer's
    reachable servers, the rest uniform over all servers (mostly
    infeasible); the first two are single-server placements on the two
    strongest servers (often feasible). Padded genes 0; pins honoured on
    the link-aware part."""
    p, s = prob.num_layers, prob.num_servers
    X = np.zeros((P, max_p), np.int32)
    X[:, :p] = rng.integers(0, s, size=(P, p))
    home = np.where(prob.pinned >= 0, prob.pinned, 0)
    home = np.array([home[prob.app_id == a].max() for a in prob.app_id])
    n_aware = int(P * frac)
    for j in range(p):
        allowed = np.flatnonzero(prob.link_ok[home[j]] |
                                 (np.arange(s) == home[j]))
        X[:n_aware, j] = rng.choice(allowed, size=n_aware)
    X[:2, :p] = np.argsort(-prob.power, kind="stable")[:2, None]
    pinned = prob.pinned >= 0
    X[:n_aware, :p][:, pinned] = prob.pinned[pinned]
    return X


# ---------------------------------------------------------------------------
# problem data: copies of the numpy modules agree with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ref.zoo.NAMES)
def test_zoo_dags_equal(net):
    a, b = ref.zoo.build(net, pin_server=3), port.zoo.build(net, pin_server=3)
    for field in ("compute", "edges", "edge_mb", "app_id", "deadline",
                  "pinned"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.names == b.names
    np.testing.assert_array_equal(ref.topological_order(a),
                                  port.topological_order(b))


@pytest.mark.parametrize("env_name", ["paper_environment",
                                      "sample_environment",
                                      "tpu_fleet_environment"])
def test_environments_equal(env_name):
    a, b = getattr(ref, env_name)(), getattr(port, env_name)()
    for field in ("power", "cost_per_sec", "tier", "bandwidth",
                  "tran_cost"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("net", ref.zoo.NAMES)
def test_simproblem_and_padding_equal(net):
    env_r, env_p = ref.paper_environment(), port.paper_environment()
    dags = [ref.zoo.build(net, pin_server=d) for d in range(2)]
    pr = ref.SimProblem.build(ref.merge_dags(dags), env_r)
    pt = port.SimProblem.build(
        port.merge_dags([port.zoo.build(net, pin_server=d)
                         for d in range(2)]), env_p)
    for field in pr.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(pr, field),
                                      getattr(pt, field))
    sizes = dict(max_p=pr.num_layers + 5, max_S=32, max_apps=4)
    pp_r = ref.pad_problem(pr, **sizes)
    pp_p = port.pad_problem(pt, device=CPU, **sizes)
    converted = to_port(pp_r)
    for field in port.PaddedProblem._fields:
        got, want = getattr(pp_p, field), getattr(converted, field)
        assert got.dtype == want.dtype, field
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_preprocess_equal():
    a, ga = ref.preprocess(ref.zoo.build("googlenet"))
    b, gb = port.preprocess(port.zoo.build("googlenet"))
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.compute, b.compute)
