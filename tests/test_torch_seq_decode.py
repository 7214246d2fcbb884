"""Sequence-parallel batch-1 decode (the reference's ``shard_seq``) against
the reference's unsharded serving, on the CPU.

A batch of 1 on a data axis > 1: the prefill runs replicated on every data
shard, each rank keeps ``C/n`` slots of every KV cache (Mamba2 states
whole), and each decode step attends the rank's live slots and merges the
ranks' outputs by their log-sum-exps. Each ``tests/mesh_rank.py::
SEQ_CASES`` model (reduced float32 qwen3, gemma3's local rings, mixtral's
sliding window, zamba2, whisper, the int8 cache, and a short prompt that
leaves rank 3 of 4 with no live slot at first) is served by ``gloo`` ranks
of ``tests/mesh_rank.py seq-decode`` on ``(2, 1)`` and ``(4, 1)``; the
reference serves the same one-row batch unsharded in this process. On
every rank the prefill's and every decode step's logits are within 1e-4
(atol and rtol) of the reference's, the greedy tokens and
``Server.generate``'s are the reference's, and the ranks agree bit for
bit. The merge itself is held to the unsliced plain B4 at 1e-6.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mesh_rank import (HELPER, SEQ_CASES, SEQ_NEW, SPAWN_TIMEOUT_S,
                       child_env, seq_cfg, serve_start)

from repro.configs import get as ref_get
from repro.models import build_model as ref_build
from repro_torch.configs import get
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.launch.serve import request_batch
from repro_torch.models import params_from_reference

TOL = 1e-4
WORLDS = (2, 4)


def _reference(case, seed):
    """The reference's parameters (whole, under the port's names), the
    one-row batch, and its unsharded prefill and greedy decode: logits
    (1, SEQ_NEW, V) and tokens (1, SEQ_NEW)."""
    cfg, prompt = seq_cfg(get, case)
    rcfg, _ = seq_cfg(ref_get, case)
    model = ref_build(rcfg)
    params = model.init(jax.random.PRNGKey(seed))
    state = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    batch = request_batch(cfg, 1, prompt, np.random.default_rng(seed))
    pos = serve_start(cfg, batch)
    prefill = jax.jit(lambda p, b: model.prefill(
        p, b, cache_len=prompt + SEQ_NEW))
    decode = jax.jit(model.decode_step)
    lg, caches = prefill(params, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    logits, toks = [np.asarray(lg)], []
    for i in range(SEQ_NEW - 1):
        toks.append(np.asarray(jnp.argmax(lg[:, -1], -1))[:, None])
        lg, caches = decode(params, caches, {
            "token": jnp.asarray(toks[-1], jnp.int32),
            "pos": jnp.asarray(pos + i, jnp.int32)})
        logits.append(np.asarray(lg))
    toks.append(np.asarray(jnp.argmax(lg[:, -1], -1))[:, None])
    return ({k: v.numpy() for k, v in state.items()}, batch,
            np.concatenate(logits, 1), np.concatenate(toks, 1))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks of worlds 2 and 4 (processes, all started together) and
    the reference's runs, made while they serve."""
    tmp = tmp_path_factory.mktemp("seq")
    want, arrays = {}, {}
    for seed, case in enumerate(SEQ_CASES):
        cfg, prompt = seq_cfg(get, case)
        rcfg, _ = seq_cfg(ref_get, case)
        params = ref_build(rcfg).init(jax.random.PRNGKey(seed))
        for k, v in params_from_reference(
                cfg, jax.tree.map(np.asarray, params)).items():
            arrays[f"{case}.param.{k}"] = v.numpy()
        for k, v in request_batch(cfg, 1, prompt,
                                  np.random.default_rng(seed)).items():
            arrays[f"{case}.batch.{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    procs = {}
    for world in WORLDS:
        (tmp / f"w{world}").mkdir()
        procs[world] = [subprocess.Popen(
            [sys.executable, str(HELPER), "seq-decode", str(r), str(world),
             str(tmp / f"w{world}" / "store"), str(tmp / f"w{world}" / "out"),
             str(tmp / "in.npz")], env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        for seed, case in enumerate(SEQ_CASES):
            want[case] = _reference(case, seed)
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
    return want, ranks


@pytest.mark.parametrize("case", list(SEQ_CASES))
@pytest.mark.parametrize("world", WORLDS, ids=[f"{w}x1" for w in WORLDS])
def test_seq_parallel_decode_matches_reference(served, world, case):
    """Prefill and every decode step's logits within 1e-4 of the
    reference's unsharded batch-1 serving, the greedy tokens (and
    ``Server.generate``'s) equal, on every rank; each rank's first KV
    cache holds its share of the slots."""
    want, ranks = served
    _, _, logits, toks = want[case]
    cfg, prompt = seq_cfg(get, case)
    slots = prompt + SEQ_NEW
    if cfg.window and cfg.family != "hybrid":
        slots = min(slots, cfg.window)
    for r, o in enumerate(ranks[world]):
        got = o[f"{case}.logits"]
        assert got.shape == logits.shape, (r, got.shape)
        np.testing.assert_allclose(got, logits, atol=TOL, rtol=TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(o[f"{case}.tokens"], toks,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(o[f"{case}.generate"], toks,
                                      err_msg=f"rank {r}")
        assert int(o[f"{case}.slots"]) == slots // world, (r, case)


@pytest.mark.parametrize("world", WORLDS, ids=[f"{w}x1" for w in WORLDS])
def test_ranks_agree_bit_for_bit(served, world):
    """Every rank returns the same logits and tokens: the merge runs on
    the same gathered partials everywhere."""
    _, ranks = served
    for key in ranks[world][0]:
        if not key.endswith(".slots"):
            for o in ranks[world][1:]:
                np.testing.assert_array_equal(o[key], ranks[world][0][key],
                                              err_msg=key)


def _merge(parts):
    """The log-sum-exp merge of (out, lse) pairs (``attention.
    seq_combine``'s arithmetic on one process)."""
    o = torch.stack([p[0].float() for p in parts])
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.amax(dim=0))
    return (w[..., None] * o).sum(0) / w.sum(0)[..., None]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_lse_merge_of_slices_matches_unsliced(n):
    """``decode_attention_plain(return_lse=True)`` over ``n`` slices of one
    cache (the last one past the live slots: ``o = 0``, ``lse = −inf``),
    merged by their log-sum-exps, is the unsliced plain version within
    1e-6; its lse is the masked scores' logsumexp."""
    rng = np.random.default_rng(n)
    B, K, G, C, hd = 2, 2, 3, 12 * n, 16
    q = torch.from_numpy(rng.standard_normal((B, K, G, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, K, C, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, K, C, hd)).astype(
        np.float32))
    valid = C - 12 - 5              # the last slice holds no live slot
    want, want_lse = decode_attention_plain(q, k, v, valid, return_lse=True)
    s = torch.einsum("bkgd,bkcd->bkgc", q, k)[..., :valid] * hd ** -0.5
    np.testing.assert_allclose(want_lse, torch.logsumexp(s, -1), atol=1e-6)
    c = C // n
    parts = []
    for r in range(n):
        live = min(max(valid - r * c, 0), c)
        if live:
            parts.append(decode_attention_plain(
                q, k[:, :, r * c:(r + 1) * c], v[:, :, r * c:(r + 1) * c],
                live, return_lse=True))
        else:
            parts.append((torch.zeros_like(q),
                          torch.full((B, K, G), -torch.inf)))
    np.testing.assert_allclose(_merge(parts), want, atol=1e-6, rtol=1e-6)
    # the folded (BK, G, hd) layout returns a (BK, G) lse
    o3, l3 = decode_attention_plain(q.reshape(B * K, G, hd),
                                    k.reshape(B * K, C, hd),
                                    v.reshape(B * K, C, hd), valid,
                                    return_lse=True)
    np.testing.assert_array_equal(l3, want_lse.reshape(B * K, G))
    np.testing.assert_array_equal(o3, want.reshape(B * K, G, hd))


class _DataMesh:
    """What a ``DeviceMesh`` tells a model: ``(data n, model 1)``, this
    process at data coordinate ``r``."""

    def __init__(self, n, r):
        self.mesh_dim_names, self.shape, self.r = ("data", "model"), (n, 1), r

    def get_coordinate(self):
        return [self.r, 0]


# (window, cache_len, prefill_len): a global cache, a ring the prompt
# filled and rolled, a ring the prompt left short
GROW_CASES = {"global": (0, 24, 13), "ring-rolled": (8, 24, 13),
              "ring-short": (8, 24, 5)}


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("case", list(GROW_CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_grow_cache_seq_keeps_the_shards_slots(n, case, kv_dtype):
    """``grow_cache(seq=True)`` on data shard ``r`` of ``n`` is slots
    ``[r·C/n, (r+1)·C/n)`` of the grown cache, bit for bit, and the shards
    together are the whole of it (values and int8 scales, a layer-stacked
    cache)."""
    from repro_torch.models.attention import grow_cache, quantize_kv
    from repro_torch.models.layers import Sharding
    window, cache_len, s = GROW_CASES[case]
    cfg = dataclasses.replace(get("gemma3-27b").reduced(), window=window,
                              kv_dtype=kv_dtype)
    gen = torch.Generator().manual_seed(n)
    kept = min(window, s) if window else s
    k = torch.randn((3, 1, kept, 2, 8), generator=gen)
    v = torch.randn((3, 1, kept, 2, 8), generator=gen)
    if kv_dtype == "int8":
        (qk, sk), (qv, sv) = quantize_kv(k), quantize_kv(v)
        cache = {"k": qk, "k_s": sk, "v": qv, "v_s": sv}
    else:
        cache = {"k": k, "v": v}
    whole = grow_cache(cache, cfg, not window, cache_len, s)
    for name, t in whole.items():
        parts = []
        for r in range(n):
            sh = Sharding(_DataMesh(n, r))
            part = grow_cache(cache, cfg, not window, cache_len, s, sh,
                              seq=True)[name]
            own = sh.seq_slots(t.shape[-3])
            torch.testing.assert_close(part, t[..., own, :, :], rtol=0,
                                       atol=0)
            parts.append(part)
        torch.testing.assert_close(torch.cat(parts, -3), t, rtol=0, atol=0)
