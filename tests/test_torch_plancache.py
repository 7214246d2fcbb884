"""The plan cache in the port (``repro_torch.core.plancache``) against the
reference (``tests/test_plan_cache.py``, mirrored): byte-equal DAG
fingerprints and cache keys for the same DAG, environment and load scale,
the replay-exact gate's decisions, LRU eviction, and the service
integration (cache-hit rounds bit-identical to fresh solves, node-loss
composition, a cache shared by ``run_services``)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port

torch.set_num_threads(1)

FAST = port.PSOGAConfig(pop_size=24, max_iters=60, stall_iters=20)
RCFG = port.ReplanConfig(pso=FAST)


def _tiny_dag(lib, env, pin):
    return lib.LayerDAG(
        compute=np.array([1.1, 1.92, 2.35, 2.12]) * env.power[0],
        edges=np.array([[0, 1], [0, 2], [1, 3], [2, 3]]),
        edge_mb=np.array([1.0, 1.0, 0.5, 0.5]),
        app_id=np.zeros(4, np.int32), deadline=np.array([3.7]),
        pinned=np.array([pin, -1, -1, -1], np.int32))


@pytest.fixture(scope="module")
def tiny_fleet():
    env = port.sample_environment()
    return env, [_tiny_dag(port, env, 0), _tiny_dag(port, env, 1)]


# ---------------------------------------------------------------------------
# keys: byte-equal to the reference's
# ---------------------------------------------------------------------------

def _envs(lib):
    """Environments that exercise every bucket: the paper's, a sampled
    one (Fig. 2), a faded copy, one with a severed link, the TPU fleet."""
    paper = lib.paper_environment()
    bw = np.asarray(paper.bandwidth, float).copy()
    bw[0, 1] = bw[1, 0] = 0.0
    return [paper, lib.sample_environment(),
            dataclasses.replace(paper, bandwidth=paper.bandwidth * 0.93),
            dataclasses.replace(paper, bandwidth=bw),
            lib.tpu_fleet_environment()]


def _dags(lib):
    env = lib.paper_environment()
    out = [_tiny_dag(lib, env, 0), _tiny_dag(lib, env, 1)]
    for i, net in enumerate(("alexnet", "googlenet")):
        dag = lib.zoo.build(net, pin_server=i)
        h, _ = lib.heft_makespan(dag, env)
        out.append(dag.with_deadline(np.array([1.5 * h])))
    out.append(lib.merge_dags(out[2:]))
    return out


def test_fingerprints_and_keys_are_byte_equal_to_reference():
    cfg = dict(capacity=8, env_quant=0.05, load_quant=0.1)
    rc, pc = ref.PlanCache(ref.PlanCacheConfig(**cfg)), \
        port.PlanCache(port.PlanCacheConfig(**cfg))
    for dr, dp in zip(_dags(ref), _dags(port)):
        fp = port.dag_fingerprint(dp)
        assert isinstance(fp, bytes) and fp == ref.dag_fingerprint(dr)
        for er, ep in zip(_envs(ref), _envs(port)):
            for scale in (1e-6, 0.5, 1.0, 1.04, 3.7):
                kr, kp = rc.key(dr, er, scale), pc.key(dp, ep, scale)
                assert kp == kr
                assert pc.key(fp, ep, scale) == kr     # by fingerprint


def test_quantize_matches_reference():
    from repro.core.plancache import _quantize as ref_q
    from repro_torch.core.plancache import _quantize as port_q
    a = np.array([[0.0, np.inf, 1e-9], [3.0, 1e12, 0.051]])
    for q in (0.05, 0.1, 1.0):
        got, want = port_q(a, q), ref_q(a, q)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kwargs,match", [
    ({"capacity": 0}, "capacity"),
    ({"env_quant": 0.0}, "env_quant"),
    ({"env_quant": float("nan")}, "env_quant"),
    ({"load_quant": -0.1}, "load_quant"),
])
def test_plan_cache_config_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        port.PlanCacheConfig(**kwargs)


def test_dag_fingerprint_tracks_content(tiny_fleet):
    env, (d0, d1) = tiny_fleet
    assert port.dag_fingerprint(d0) == \
        port.dag_fingerprint(_tiny_dag(port, env, 0))
    assert port.dag_fingerprint(d0) != port.dag_fingerprint(d1)
    fatter = dataclasses.replace(d0, edge_mb=d0.edge_mb * 2.0)
    assert port.dag_fingerprint(d0) != port.dag_fingerprint(fatter)


def test_key_buckets_env_and_load(tiny_fleet):
    env, (d0, _) = tiny_fleet
    cache = port.PlanCache(port.PlanCacheConfig(env_quant=0.05,
                                                load_quant=0.1))
    k = cache.key(d0, env)
    near = dataclasses.replace(
        env, bandwidth=np.asarray(env.bandwidth, float) * 1.001)
    assert cache.key(d0, near) == k
    far = dataclasses.replace(
        env, bandwidth=np.asarray(env.bandwidth, float) * 0.5)
    assert cache.key(d0, far) != k
    bw = np.asarray(env.bandwidth, float).copy()
    bw[0, 1] = 0.0
    assert cache.key(d0, dataclasses.replace(env, bandwidth=bw)) != k
    assert cache.key(d0, env, 1.0) == cache.key(d0, env, 1.01)
    assert cache.key(d0, env, 1.0) != cache.key(d0, env, 2.0)


def test_key_rejects_bad_inputs(tiny_fleet):
    env, (d0, _) = tiny_fleet
    cache = port.PlanCache()
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="load_scale"):
            cache.key(d0, env, bad)
    bw = np.asarray(env.bandwidth, float).copy()
    bw[0, -1] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        cache.key(d0, dataclasses.replace(env, bandwidth=bw))


# ---------------------------------------------------------------------------
# store / lookup / the replay-exact gate
# ---------------------------------------------------------------------------

def test_store_lookup_roundtrip_and_gate(tiny_fleet):
    env, (d0, _) = tiny_fleet
    prob = port.SimProblem.build(d0, env)
    plan = np.array([0, 1, 1, 1], np.int32)
    assert port.plan_is_valid(prob, plan)
    cache = port.PlanCache()
    key = cache.key(d0, env)
    assert cache.store(key, prob, plan)
    got = cache.lookup(key, prob)
    assert got is not None and np.array_equal(got, plan)
    assert cache.stats()["hits"] == 1
    near = dataclasses.replace(
        env, bandwidth=np.asarray(env.bandwidth, float) * 1.001)
    assert cache.key(d0, near) == key
    assert cache.lookup(key, port.SimProblem.build(d0, near)) is None
    st = cache.stats()
    assert st["revalidation_failures"] == 1 and st["misses"] == 1
    assert len(cache) == 0


def test_store_rejects_invalid_plans(tiny_fleet):
    env, (d0, _) = tiny_fleet
    prob = port.SimProblem.build(d0, env)
    cache = port.PlanCache()
    assert not cache.store(cache.key(d0, env), prob,
                           np.array([1, 1, 1, 1], np.int32))
    assert cache.stats()["store_rejects"] == 1 and len(cache) == 0


def test_lookup_fleet_is_all_or_nothing(tiny_fleet):
    env, (d0, d1) = tiny_fleet
    p0, p1 = port.SimProblem.build(d0, env), port.SimProblem.build(d1, env)
    cache = port.PlanCache()
    k0, k1 = cache.key(d0, env), cache.key(d1, env)
    cache.store(k0, p0, np.array([0, 1, 1, 1], np.int32))
    assert cache.lookup_fleet([k0, k1], [p0, p1]) is None
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 0
    with pytest.raises(ValueError, match="keys"):
        cache.lookup_fleet([k0], [p0, p1])


def test_lru_eviction_respects_capacity(tiny_fleet):
    env, (d0, _) = tiny_fleet
    prob = port.SimProblem.build(d0, env)
    plan = np.array([0, 1, 1, 1], np.int32)
    cache = port.PlanCache(port.PlanCacheConfig(capacity=2))
    keys = [cache.key(d0, env, s) for s in (1.0, 2.0, 4.0)]
    cache.store(keys[0], prob, plan)
    cache.store(keys[1], prob, plan)
    assert cache.lookup(keys[0], prob) is not None
    cache.store(keys[2], prob, plan)
    assert len(cache) == 2 and cache.stats()["evictions"] == 1
    assert set(cache.keys()) == {keys[0], keys[2]}
    assert cache.lookup(keys[1], prob) is None
    assert cache.hit_rate() == pytest.approx(1 / 2)


def test_gate_decisions_equal_reference():
    """The same store / lookup script on both packages' caches, over the
    paper's zoo DNNs under drifted environments: every decision, the
    stats and the LRU order agree."""
    def script(lib):
        cache = lib.PlanCache(lib.PlanCacheConfig(capacity=5))
        tel = lib.Telemetry(clock=lambda: 0.0)
        cache_t = lib.PlanCache(lib.PlanCacheConfig(capacity=5),
                                telemetry=tel)
        env = lib.paper_environment()
        dags = _dags(lib)[2:]
        out = []
        rng = np.random.default_rng(2)
        for step in range(30):
            d = dags[step % len(dags)]
            e = dataclasses.replace(
                env, bandwidth=env.bandwidth * float(rng.choice(
                    [1.0, 1.001, 0.6])))
            pr = lib.SimProblem.build(d, e)
            plan = np.asarray(lib.heft_makespan(d, e)[1], np.int32)
            if step % 4 == 3:
                plan = plan.copy()
                plan[0] = (plan[0] + 1) % pr.num_servers  # breaks the pin
            for c in (cache, cache_t):
                k = c.key(d, e, float(rng.choice([1.0, 2.0])))
                out.append((c.store(k, pr, plan) if step % 2 else None,
                            None if (got := c.lookup(k, pr)) is None
                            else got.tolist()))
        return out, cache.stats(), cache_t.stats(), cache.keys(), \
            tel.registry.to_jsonl()

    assert script(port) == script(ref)


# ---------------------------------------------------------------------------
# service integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zero_drift_off(tiny_fleet):
    env, dags = tiny_fleet
    trace = port.zero_drift_trace(env, rounds=4)
    return trace, port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG), seed=11, device="cpu")


def test_cached_rounds_bit_identical_to_fresh_solves(tiny_fleet,
                                                     zero_drift_off):
    env, dags = tiny_fleet
    trace, off = zero_drift_off
    assert all(not r.replan.replanned.any() for r in off.rounds)
    on = port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG, plan_cache=port.PlanCacheConfig()), seed=11,
        device="cpu")
    assert on.rounds[0].rung == ("warm", "warm")
    assert not on.rounds[0].cache_hit
    for r in on.rounds[1:]:
        assert r.cache_hit and r.rung == ("cached", "cached")
        assert r.replan is None
    st = on.cache_stats
    assert st["stores"] == 2 and st["misses"] == 2
    assert st["hits"] == 2 * (len(on.rounds) - 1)
    assert st["revalidation_failures"] == 0
    assert on.availability() == 1.0
    for x_on, x_off, d in zip(on.plans, off.plans, dags):
        assert np.array_equal(x_on, x_off)
        prob = port.SimProblem.build(d, trace.env_at(trace.num_rounds - 1))
        assert (float(port.simulate_np(prob, x_on).total_cost)
                == float(port.simulate_np(prob, x_off).total_cost))


def test_env_drift_outside_bucket_misses(tiny_fleet):
    env, dags = tiny_fleet
    trace = port.sample_trace("wifi-fade", env, rounds=4, seed=3)
    off = port.run_service(dags, trace, port.ServiceConfig(replan=RCFG),
                           seed=11, device="cpu")
    on = port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG, plan_cache=port.PlanCacheConfig()), seed=11,
        device="cpu")
    assert on.cache_stats["hits"] == 0
    assert not any(r.cache_hit for r in on.rounds)
    for x_on, x_off in zip(on.plans, off.plans):
        assert np.array_equal(x_on, x_off)


def test_node_loss_invalidation_composes_with_cache(tiny_fleet,
                                                    zero_drift_off):
    env, dags = tiny_fleet
    trace, base = zero_drift_off
    used = sorted(set(int(s) for x in base.plans for s in x) - {0, 1})
    assert used, "tiny plans collapsed onto the pinned servers"
    rep = port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG, plan_cache=port.PlanCacheConfig(),
        chaos=port.ChaosConfig(mid_round_down={2: used[0]})), seed=11,
        device="cpu")
    r2 = rep.rounds[1]
    assert r2.cache_hit and any(g != "cached" for g in r2.rung)
    assert rep.availability() == 1.0
    for d, x in zip(dags, rep.plans):
        assert x is not None
        assert port.plan_is_valid(port.SimProblem.build(d, trace.env_at(3)),
                                  x)


def test_run_services_broadcast_validation(tiny_fleet):
    env, dags = tiny_fleet
    trace = port.zero_drift_trace(env, rounds=2)
    with pytest.raises(ValueError, match="seeds"):
        port.run_services([dags] * 2, trace, seeds=[1, 2, 3], device="cpu")
    assert port.run_services([], trace) == []


def test_run_services_shared_plan_cache(tiny_fleet, zero_drift_off):
    """Three services over one shared cache: every service serves the
    plans it would serve alone, and repeat scenarios hit across service
    boundaries."""
    env, dags = tiny_fleet
    trace = port.zero_drift_trace(env, rounds=3)
    cache = port.PlanCache()
    cfg = port.ServiceConfig(replan=RCFG, plan_cache=port.PlanCacheConfig())
    reports = port.run_services([dags] * 3, trace, cfg, seeds=11,
                                plan_cache=cache, device="cpu")
    st = cache.stats()
    assert st["hits"] + st["misses"] == 3 * 2 * 2
    assert st["hits"] >= 2 * 2
    _, solo = zero_drift_off
    for rep in reports:
        assert rep.availability() == 1.0 and rep.cache_stats is not None
        for x, x_solo in zip(rep.plans, solo.plans):
            assert np.array_equal(x, x_solo)
