"""Tensor- and expert-parallel serving on a device mesh against the
reference's unsharded serving, on the CPU.

Each served case of ``tests/mesh_rank.py::SERVE_CASES`` (reduced float32
configs of the dense, gemma3, MoE, arctic, VLM, whisper, mamba2 and zamba2
families, and the fallbacks reached on purpose: replicated kv at tp 4,
partial-sum q heads at tp 4, uneven kv groups at tp 2, the MLP's swapped
layout and per-expert d_ff TP at tp 4, the three ``moe_shard`` layouts,
and ``moe_impl="a2a"`` beside tensor-parallel attention) is served by
``gloo`` ranks of ``tests/mesh_rank.py`` on ``(data, model)`` meshes
``(1, 2)`` and ``(2, 1)`` (world 2) and ``(1, 4)`` and ``(2, 2)`` (world
4): each rank builds the model on its mesh, loads its slices of the
reference's parameters, prefills a 4-row batch and decodes greedily. The
reference runs the same cases unsharded in this process. On every rank
the prefill logits and every decode step's logits are within 1e-4 (atol
and rtol: partial sums add in another order) of the reference's, the
greedy tokens are the reference's, and on ``(2, 2)`` the three
``moe_shard`` layouts give equal logits bit for bit (the mesh form of
``tests/test_perf_knobs.py::test_moe_shard_layouts_invariant``).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from mesh_rank import (HELPER, SERVE_BATCH, SERVE_CASES, SERVE_PROMPT,
                       SERVE_STEPS, SPAWN_TIMEOUT_S, child_env, serve_cfg,
                       serve_meshes, serve_start)

from repro.configs import get as ref_get
from repro.models import build_model as ref_build
from repro_torch.configs import get
from repro_torch.launch.serve import request_batch
from repro_torch.models import params_from_reference

TOL = 1e-4
#: cases served on the same reference run: the layouts of one model
SAME_AS = {"moe-ep_fsdp": "moe", "moe-ep_only": "moe", "moe-a2a": "moe"}
WORLDS = (2, 4)


def _reference(case, seed):
    """The reference's parameters (whole, under the port's names), the
    batch, and its unsharded prefill and greedy decode: logits (B, 1 +
    steps, V) and tokens (B, steps)."""
    cfg, _ = serve_cfg(get, case)
    rcfg, _ = serve_cfg(ref_get, case)
    model = ref_build(rcfg)
    params = model.init(jax.random.PRNGKey(seed))
    state = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    batch = request_batch(cfg, SERVE_BATCH, SERVE_PROMPT,
                          np.random.default_rng(seed))
    pos = serve_start(cfg, batch)
    prefill = jax.jit(lambda p, b: model.prefill(
        p, b, cache_len=pos + SERVE_STEPS))
    decode = jax.jit(model.decode_step)
    lg, caches = prefill(params, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    logits, toks = [np.asarray(lg)], []
    for i in range(SERVE_STEPS):
        toks.append(np.asarray(jnp.argmax(lg[:, -1], -1))[:, None])
        lg, caches = decode(params, caches, {
            "token": jnp.asarray(toks[-1], jnp.int32),
            "pos": jnp.asarray(pos + i, jnp.int32)})
        logits.append(np.asarray(lg))
    return ({k: v.numpy() for k, v in state.items()}, batch,
            np.concatenate(logits, 1), np.concatenate(toks, 1))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks of worlds 2 and 4 (processes, all started together) and
    the reference's runs, made while they serve."""
    tmp = tmp_path_factory.mktemp("serve")
    seeds = {case: i for i, case in enumerate(SERVE_CASES)}
    for case, base in SAME_AS.items():
        seeds[case] = seeds[base]
    arrays = {"cases": np.array(list(SERVE_CASES))}
    for case in SERVE_CASES:
        cfg, _ = serve_cfg(get, case)
        rcfg, _ = serve_cfg(ref_get, case)
        params = ref_build(rcfg).init(jax.random.PRNGKey(seeds[case]))
        for k, v in params_from_reference(
                cfg, jax.tree.map(np.asarray, params)).items():
            arrays[f"{case}.param.{k}"] = v.numpy()
        for k, v in request_batch(cfg, SERVE_BATCH, SERVE_PROMPT,
                                  np.random.default_rng(seeds[case])).items():
            arrays[f"{case}.batch.{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    procs = {}
    for world in WORLDS:
        (tmp / f"w{world}").mkdir()
        procs[world] = [subprocess.Popen(
            [sys.executable, str(HELPER), "serve", str(r), str(world),
             str(tmp / f"w{world}" / "store"), str(tmp / f"w{world}" / "out"),
             str(tmp / "in.npz")], env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        want = {}
        for case in SERVE_CASES:
            if case not in SAME_AS:
                want[case] = _reference(case, seeds[case])
        logs = {w: [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in ps]
                for w, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for world, ps in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"rank {r} of {world}:\n{logs[world][r]}"
    ranks = {w: [dict(np.load(tmp / f"w{w}" / f"out-{r}.npz"))
                 for r in range(w)] for w in WORLDS}
    for case, base in SAME_AS.items():
        want[case] = want[base]
    return want, ranks


CELLS = [(w, "x".join(map(str, shape))) for w in WORLDS
         for shape in serve_meshes(w)]


@pytest.mark.parametrize("case", list(SERVE_CASES))
@pytest.mark.parametrize("world,mesh", CELLS,
                         ids=[f"mesh{m}" for _, m in CELLS])
def test_sharded_serving_matches_reference(served, world, mesh, case):
    """Prefill and every decode step's logits within 1e-4 of the
    reference's unsharded ones, the greedy tokens equal, on every rank."""
    want, ranks = served
    _, _, logits, toks = want[case]
    for r, o in enumerate(ranks[world]):
        got = o[f"{mesh}.{case}.logits"]
        assert got.shape == logits.shape, (r, got.shape)
        np.testing.assert_allclose(got, logits, atol=TOL, rtol=TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(o[f"{mesh}.{case}.tokens"], toks,
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("world,mesh", CELLS,
                         ids=[f"mesh{m}" for _, m in CELLS])
def test_ranks_agree_bit_for_bit(served, world, mesh):
    """Every rank returns the same logits and tokens: the gathered logits
    are one tensor on every rank."""
    _, ranks = served
    for key in ranks[world][0]:
        if key.startswith(mesh + "."):
            for o in ranks[world][1:]:
                np.testing.assert_array_equal(o[key], ranks[world][0][key],
                                              err_msg=key)


def test_moe_shard_layouts_equal_on_2x2(served):
    """ep_ftp (d_ff over data), ep_fsdp (d_model over data) and ep_only
    gather the same banks before use: equal logits bit for bit."""
    _, ranks = served
    for o in ranks[4]:
        base = o["2x2.moe.logits"]
        for case in ("moe-ep_fsdp", "moe-ep_only"):
            np.testing.assert_array_equal(o[f"2x2.{case}.logits"], base)
