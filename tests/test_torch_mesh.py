"""The port's device mesh and the fleet solver sharded over it, on the
CPU: mesh construction (``launch/mesh.py``, ``runtime.elastic_mesh``) at
worlds 1, 2 and 4, and the sharded solve, a replan round and the planning
service against the unsharded port and the reference.

World 1 runs in this process (``gloo`` from a ``HashStore``); worlds 2
and 4 are ranks of ``tests/mesh_rank.py`` spawned as processes that meet
through a ``FileStore`` and hand their results back as ``.npz``. World 2
shards the solve with ``elastic_mesh(model=1)`` (2 data shards; the test
mesh of 2 devices is ``(data 1, model 2)`` and does not shard it), world
4 with ``make_test_mesh()`` (2 data shards, model replicas solving the
same rows). Sharded results equal unsharded ones bit for bit: genes,
keys, costs, iterations, feasibility. Against the reference (three
problems of one bucket, padded to four rows, on the reference's
legacy-stream draws) genes, iterations and feasibility are exact and keys
and costs within rtol 1e-5, as ``tests/test_torch_parity.py``.
"""
import numpy as np
import pytest
import torch.distributed as dist
from mesh_rank import (CFG_KW, arrivals_for, fleet, run_service, spawn,
                       trio)
from test_torch_parity import CPU, RTOL, RefDraws, legacy_stream, port_cfg

import repro.core as ref
import repro_torch.core as port
from repro_torch.core.pso_ga import SwarmDraws
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import plan as plan_cli
from repro_torch.launch.plan import chaos_script
from repro_torch.runtime import elastic_mesh

CFG = port.PSOGAConfig(**CFG_KW)
CFG_REF = ref.PSOGAConfig(**CFG_KW)


def ref_draw_inputs(path):
    """The reference's legacy-stream initial swarms and ``max_iters``
    steps of draws for ``trio``, as the ranks' ``X0`` / ``draw_fn``."""
    probs = [ref.SimProblem.build(d, e) for d, e in trio(ref)]
    draws = RefDraws(probs, CFG_REF, [1, 2, 3])
    arrays = {f"X0.{i}": x for i, x in enumerate(draws.X0)}
    for i in range(len(probs)):
        steps = [draws(i, s) for s in range(CFG.max_iters)]
        for f in SwarmDraws._fields:
            arrays[f"draw{i}.{f}"] = np.stack(
                [np.asarray(getattr(d, f)) for d in steps])
    np.savez(path, **arrays)
    return arrays


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "in.npz"
    return path, ref_draw_inputs(path)


@pytest.fixture(scope="module")
def ranks2(inputs, tmp_path_factory):
    return 2, spawn("solve", 2, tmp_path_factory.mktemp("w2"), inputs[0])


@pytest.fixture(scope="module")
def ranks4(inputs, tmp_path_factory):
    return 4, spawn("solve", 4, tmp_path_factory.mktemp("w4"), inputs[0])


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


@pytest.fixture(scope="module")
def world1():
    """A ``gloo`` world of one in this process, torn down after."""
    started = not dist.is_initialized()
    pmesh.init_world(CPU)
    yield
    if started:
        dist.destroy_process_group()


def _draw_fn(arrays):
    def draw_fn(i, step):
        return SwarmDraws(*(arrays[f"draw{i}.{f}"][step]
                            for f in SwarmDraws._fields))
    return draw_fn


@pytest.fixture(scope="module")
def unsharded(inputs):
    """The same solves as a rank's, on one device without a mesh."""
    probs = fleet(port)
    n = len(probs)
    out = {"cold": port.run_pso_ga_batch(probs, CFG, seed=list(range(n)),
                                         device=CPU)}
    inc = [r.best_x for r in out["cold"]]
    out["warm"], out["warm_state"] = port.run_pso_ga_batch(
        probs, CFG, seed=9, device=CPU, incumbent=inc, migration_weight=1.0,
        warm_rescue=[i % 2 == 0 for i in range(n)], return_state=True)
    out["traffic"] = port.run_pso_ga_batch(probs, CFG, seed=6, device=CPU,
                                           arrivals=arrivals_for(n))
    out["trio"] = port.run_pso_ga_batch(trio(port), CFG, seed=[1, 2, 3],
                                        device=CPU)
    arrays = inputs[1]
    out["legacy"] = port.run_pso_ga_batch(
        trio(port), CFG, seed=[1, 2, 3], device=CPU,
        X0=[arrays[f"X0.{i}"] for i in range(3)],
        draw_fn=_draw_fn(arrays))
    return out


def _assert_equal(got, prefix, want):
    for i, r in enumerate(want):
        np.testing.assert_array_equal(got[f"{prefix}.x{i}"], r.best_x)
    assert got[f"{prefix}.fit"].tolist() == [r.best_fitness for r in want]
    assert got[f"{prefix}.cost"].tolist() == [r.best_cost for r in want]
    assert got[f"{prefix}.it"].tolist() == [r.iterations for r in want]
    assert got[f"{prefix}.feas"].tolist() == [r.feasible for r in want]


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------

def test_mesh_construction_world1(world1):
    assert pmesh.resolve_mesh(None) is None
    assert pmesh.resolve_mesh("none") is None
    m = pmesh.resolve_mesh("host", device=CPU)
    assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
    assert pmesh.data_axes_of(m) == ("data",)
    assert pmesh.data_shard_count(m) == 1 and pmesh.data_index(m) == 0
    assert elastic_mesh(model=1, device=CPU).shape == (1, 1)
    with pytest.raises(ValueError, match="cannot host model=2"):
        elastic_mesh(model=2, device=CPU)
    with pytest.raises(ValueError, match="at least 4 devices"):
        pmesh.make_test_mesh(multi_pod=True, device=CPU)
    with pytest.raises(ValueError, match="a world of 256 ranks"):
        pmesh.resolve_mesh("prod", device=CPU)
    with pytest.raises(ValueError, match="unknown mesh"):
        pmesh.resolve_mesh("bogus", device=CPU)
    with pytest.raises(ValueError, match="ascending order"):
        pmesh.make_test_mesh(devices=[0, 0], device=CPU)


def test_mesh_construction(ranks):
    world, outs = ranks
    shape = {2: (2, 1), 4: (2, 2)}[world]
    for r, o in enumerate(outs):
        assert tuple(o["mesh_shape"]) == shape
        assert int(o["data_index"]) == r // shape[1]
        assert tuple(o["elastic1.shape"]) == (world, 1)
        assert int(o["elastic1.index"]) == r
        assert tuple(o["elastic2.shape"]) == (world // 2, 2)
        assert int(o["elastic2.shards"]) == world // 2
        # over the first 3 ranks of 4: rank 3 is outside the mesh
        assert tuple(o["elastic3.shape"]) == (min(3, world), 1)
        assert int(o["elastic3.index"]) == (r if r < 3 else -1)
        if world == 4:
            assert tuple(o["pod.shape"]) == (2, 1, 2)
            assert tuple(o["pod.names"]) == ("pod", "data", "model")
            assert int(o["pod.shards"]) == 2
        else:
            assert "at least 4 devices" in str(o["pod.error"])


# ---------------------------------------------------------------------------
# the sharded solve: bit for bit the unsharded one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cold", "warm", "traffic", "trio"])
def test_sharded_solve_equals_unsharded(ranks, unsharded, kind):
    """Cold, warm (incumbents, migration weight 1, rescue flags) and
    traffic solves of a two-bucket fleet, and three problems of one bucket
    padded to four rows: every rank returns the unsharded results."""
    _, outs = ranks
    for o in outs:
        _assert_equal(o, kind, unsharded[kind])
    if kind == "warm":
        st = unsharded["warm_state"]
        for o in outs:
            np.testing.assert_array_equal(o["warm.stall"], st.stall.numpy())
            np.testing.assert_array_equal(o["warm.X"], st.X.numpy())


def test_rank_outside_the_mesh_gets_every_result(ranks4, unsharded):
    """``elastic_mesh(model=1)`` over 3 of 4 ranks: 3 shards (the
    fleet's buckets of 3 and 2 rows padded to 3 each), rank 3 outside the
    mesh solves nothing; every rank returns the unsharded results."""
    _, outs = ranks4
    for o in outs:
        _assert_equal(o, "outside", unsharded["cold"])


def test_padded_bucket_matches_reference(ranks, unsharded):
    """N = 3 on 2 shards (one dummy row) on the reference's legacy-stream
    draws: equal to the port's unsharded solve on the same draws, and
    gene for gene the reference's ``run_pso_ga_batch``."""
    _, outs = ranks
    with legacy_stream():
        want = ref.run_pso_ga_batch(trio(ref), CFG_REF, seed=[1, 2, 3])
    assert port_cfg(CFG_REF) == CFG
    for o in outs:
        _assert_equal(o, "legacy", unsharded["legacy"])
        for i, w in enumerate(want):
            np.testing.assert_array_equal(o[f"legacy.x{i}"],
                                          np.asarray(w.best_x))
        assert o["legacy.it"].tolist() == [w.iterations for w in want]
        assert o["legacy.feas"].tolist() == [w.feasible for w in want]
        np.testing.assert_allclose(o["legacy.fit"],
                                   [w.best_fitness for w in want], rtol=RTOL)
        np.testing.assert_allclose(o["legacy.cost"],
                                   [w.best_cost for w in want], rtol=RTOL)


# ---------------------------------------------------------------------------
# re-planning and the service at world 2, against world 1
# ---------------------------------------------------------------------------

def test_replan_round_world2_equals_world1(ranks2, unsharded):
    _, outs = ranks2
    probs = fleet(port)
    env, dags = probs[0][1], [d for d, _ in probs]
    drifted = port.sample_trace("congestion", env, rounds=2, seed=3)
    sp = [port.SimProblem.build(d, drifted.env_at(1)) for d in dags]
    plans, log = port.replan_round(
        sp, [r.best_x for r in unsharded["cold"]],
        port.ReplanConfig(pso=CFG), seed=5, round_no=1, device=CPU)
    for o in outs:
        for i, x in enumerate(plans):
            np.testing.assert_array_equal(o[f"replan.x{i}"], x)
        for f in ("replanned", "incumbent_key", "candidate_key", "cost",
                  "iterations", "demoted"):
            np.testing.assert_array_equal(o[f"replan.{f}"],
                                          getattr(log, f))


def test_chaos_service_world2_equals_world1(ranks2):
    """Three rounds of a congestion trace under the ``--chaos`` script
    with the plan cache, walls from a fake clock: plans, rungs, walls and
    counters equal the unsharded service's."""
    _, outs = ranks2
    probs = fleet(port)
    rep = run_service(port, [d for d, _ in probs], probs[0][1], CFG, None,
                      chaos_script)
    assert rep.counters["stale_env_rounds"] == 1
    for o in outs:
        for i, x in enumerate(rep.plans):
            np.testing.assert_array_equal(o[f"service.x{i}"], x)
        assert o["service.rungs"].tolist() == [list(r.rung)
                                               for r in rep.rounds]
        assert o["service.walls"].tolist() == [r.wall_s for r in rep.rounds]
        assert o["service.counters"].tolist() == [
            [k, str(v)] for k, v in sorted(rep.counters.items())]


def test_cli_mesh_host_world1(world1, capsys):
    """``launch.plan --mesh host`` on a world of one prints the mesh and
    the plans of ``--mesh none``."""
    argv = ["--arch", "qwen3-0.6b", "--device", "cpu", "--pop", "8",
            "--iters", "5"]
    plan_cli.main(argv)
    plain = capsys.readouterr().out
    plan_cli.main(argv + ["--mesh", "host"])
    meshed = capsys.readouterr().out
    head, _, rest = meshed.partition("\n")
    assert head == ("[plan] solver mesh: {'data': 1, 'model': 1} over 1 "
                    "devices")
    strip = [ln for ln in plain.splitlines() if " planned in " not in ln]
    assert [ln for ln in rest.splitlines()
            if " planned in " not in ln] == strip
