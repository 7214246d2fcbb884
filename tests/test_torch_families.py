"""The port's gemma3 local:global groups, its VLM and its int8 KV cache
against the reference, on the CPU, and construction of every config.

* gemma3: reduced gemma3-27b (period 2, window 32: one local and one
  global layer a group), with 6 layers (3 groups) and with 7 (a tail of one
  local layer); prompts of 40 tokens, longer than the window, so the local
  layers keep rolled ring caches. Prefill logits and every cache leaf, then
  4 decode steps past the window, against the reference on the carried-over
  parameters; and the port's own teacher-forced identity.
* VLM: reduced internvl2-2b with 8 vision embeddings ahead of the tokens.
* int8: ``quantize_kv`` bit for bit; the reference's
  ``tests/test_perf_knobs.py::test_int8_kv_decode_top1_agrees`` mirrored;
  the port's int8 logits and caches against the reference's int8 ones.

Float32 throughout, the reference with ``use_pallas`` off (as its own
tests run it). Tolerance 1e-4 (rtol and atol) on logits and float caches,
as ``tests/test_torch_models.py``; 2e-3 for the teacher-forced identity,
the reference's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs import names
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro_torch.configs import get
from repro_torch.models import (TransformerLM, build_model,
                                params_from_reference, quantize_kv)

TOL = 1e-4


def _cfgs(arch, **kw):
    """(reference cfg, port cfg), reduced, float32, with ``kw`` replaced."""
    return [dataclasses.replace(c.reduced(), **kw)
            for c in (ref_get(arch), get(arch))]


def _ref_model(arch, seed=0, **kw):
    rcfg, cfg = _cfgs(arch, **kw)
    rmodel = ref_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree))
    return cfg, rmodel, params, tree, model


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _flat(tree):
    """(path, leaf) pairs of a reference or port cache tree, in jax's order
    (dict keys sorted), the paths as strings."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in pairs]


def _caches_close(got, want, msg):
    """Leaf for leaf: the same paths, shapes and dtypes; values to TOL."""
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w], msg
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == b.shape, (msg, path)
        assert str(a.dtype)[6:] == str(b.dtype), (msg, path)
        _close(a, b, f"{msg} {path}")


# ---------------------------------------------------------------------------
# gemma3: periodic local:global groups
# ---------------------------------------------------------------------------

GEMMA_LAYERS = [6, 7]


@pytest.mark.parametrize("n_layers", GEMMA_LAYERS)
def test_gemma3_layout_matches_reference(n_layers):
    """Parameters as ``blocks.<g>.<l>`` and ``tail.<t>``, each reference
    array under its indices and nothing else; ``init_caches`` nests as the
    reference's, zero-filled."""
    cfg, rmodel, _, tree, model = _ref_model("gemma3-27b", n_layers=n_layers)
    sd = model.state_dict()
    n_groups, n_tail = divmod(n_layers, cfg.local_global_period)
    assert len(model.blocks) == n_groups and len(model.tail) == n_tail
    np.testing.assert_array_equal(
        sd["blocks.1.0.attn.wq"].numpy(), tree["blocks"]["attn"]["wq"][1, 0])
    if n_tail:
        np.testing.assert_array_equal(sd["tail.0.mlp.wg"].numpy(),
                                      tree["tail"]["mlp"]["wg"][0])
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_ref
    want, got = rmodel.init_caches(2, 50), model.init_caches(2, 50)
    assert [(p, tuple(t.shape)) for p, t in _flat(got)] == \
        [(p, t.shape) for p, t in _flat(want)]
    assert not any(t.any() for _, t in _flat(got))
    assert got["groups"]["local"]["k"].shape[3] == cfg.window   # rings


@pytest.mark.parametrize("n_layers", GEMMA_LAYERS)
def test_gemma3_prefill_and_decode_match_reference(n_layers):
    """A 40-token prompt (past the 32-token window): prefill logits and
    every cache leaf (rolled rings, padded global caches), then 4 decode
    steps fed given tokens, against the reference."""
    cfg, rmodel, params, _, model = _ref_model("gemma3-27b",
                                               n_layers=n_layers)
    rng = np.random.default_rng(11)
    b, s, steps = 2, 40, 4
    cache_len = s + steps
    toks = rng.integers(0, cfg.vocab, (b, s + steps), dtype=np.int32)
    lg_ref, c_ref = jax.jit(lambda p, bb: rmodel.prefill(
        p, bb, cache_len=cache_len))(params, {"tokens": toks[:, :s]})
    lg, c = model.prefill({"tokens": toks[:, :s]}, cache_len=cache_len)
    _close(lg, lg_ref, "prefill logits")
    _caches_close(c, c_ref, "prefill caches")
    step = jax.jit(rmodel.decode_step)
    for j in range(steps):
        tok = toks[:, s + j:s + j + 1]
        lg_ref, c_ref = step(params, c_ref,
                             {"token": tok,
                              "pos": jnp.asarray(s + j, jnp.int32)})
        lg, c = model.decode_step(c, {"token": tok, "pos": s + j})
        _close(lg, lg_ref, f"decode step {j} logits")
    _caches_close(c, c_ref, "decode caches")


@pytest.mark.parametrize("n_layers", GEMMA_LAYERS)
def test_gemma3_decode_matches_prefill_teacher_forced(n_layers):
    """prefill(t[:k]) then decode t[k], ... reproduces the last-token
    logits of prefill(t[:k+j]), with k = 36 past the window (the ring
    caches wrap); the reference's own tolerance, 2e-3."""
    _, cfg = _cfgs("gemma3-27b", n_layers=n_layers)
    model = TransformerLM(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    b, k, extra = 2, 36, 4
    toks = rng.integers(0, cfg.vocab, (b, k + extra), dtype=np.int32)
    cache = k + extra
    logits, caches = model.prefill({"tokens": toks[:, :k]}, cache_len=cache)
    dec = [logits[:, -1]]
    for j in range(extra):
        logits, caches = model.decode_step(
            caches, {"token": toks[:, k + j:k + j + 1], "pos": k + j})
        dec.append(logits[:, -1])
    for j in range(extra + 1):
        want, _ = model.prefill({"tokens": toks[:, :k + j]}, cache_len=cache)
        np.testing.assert_allclose(dec[j].numpy(), want[:, -1].numpy(),
                                   atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {j}")


# ---------------------------------------------------------------------------
# VLM: projected vision embeddings ahead of the tokens
# ---------------------------------------------------------------------------

def _vlm_batch(cfg, b=2, n_text=12, seed=5):
    rng = np.random.default_rng(seed)
    return {"vision": rng.standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab, (b, n_text), dtype=np.int32)}


def test_vlm_embed_inputs_match_reference():
    cfg, rmodel, params, tree, model = _ref_model("internvl2-2b")
    assert cfg.vision_tokens == 8
    np.testing.assert_array_equal(model.vision_proj.numpy(),
                                  tree["vision_proj"])
    batch = _vlm_batch(cfg)
    want = rmodel.embed_inputs(params, batch)
    got = model.embed_batch(batch)
    assert tuple(got.shape) == want.shape == (2, 8 + 12, cfg.d_model)
    _close(got, want)
    # without vision embeddings: the scaled tokens alone
    _close(model.embed_batch({"tokens": batch["tokens"]}),
           rmodel.embed_inputs(params, {"tokens": batch["tokens"]}))


def test_vlm_prefill_and_decode_match_reference():
    """8 vision embeddings + 12 tokens: prefill logits and caches, then 4
    decode steps at positions 20.. against the reference."""
    cfg, rmodel, params, _, model = _ref_model("internvl2-2b")
    batch = _vlm_batch(cfg)
    s, steps = 20, 4
    lg_ref, c_ref = jax.jit(lambda p, bb: rmodel.prefill(
        p, bb, cache_len=s + steps))(params, batch)
    lg, c = model.prefill(batch, cache_len=s + steps)
    _close(lg, lg_ref, "prefill logits")
    _caches_close(c, c_ref, "prefill caches")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, steps),
                                             dtype=np.int32)
    step = jax.jit(rmodel.decode_step)
    for j in range(steps):
        tok = toks[:, j:j + 1]
        lg_ref, c_ref = step(params, c_ref,
                             {"token": tok,
                              "pos": jnp.asarray(s + j, jnp.int32)})
        lg, c = model.decode_step(c, {"token": tok, "pos": s + j})
        _close(lg, lg_ref, f"decode step {j} logits")


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 30.0), (2, 1e-3)])
def test_quantize_kv_bit_for_bit(seed, scale):
    """The same float32 input gives the same int8 values and float32
    scales bit for bit (rounding half to even included: exact halves are
    planted), and a zero row gets the 1e-8 floor."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((2, 9, 3, 16)) * scale).astype(np.float32)
    k[0, 0, 0] = 0.0
    k[1, 2, 1, :4] = [127.0, 0.5, -1.5, 2.5]          # halves after scaling
    k[1, 2, 1, 4:] = 0.25
    q_ref, s_ref = ref_attn.quantize_kv(jnp.asarray(k))
    q, s = quantize_kv(torch.from_numpy(k))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (2, 9, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(s_ref).view(np.int32))
    assert float(s[0, 0, 0, 0]) == np.float32(1e-8)


INT8_ARCHS = ["qwen3-0.6b", "gemma3-27b", "zamba2-7b"]


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_kv_decode_top1_agrees(arch):
    """The reference's test on the port: a 12-token prefill into a
    20-slot cache and one decode step, float cache against int8 cache:
    max |logit difference| < 0.6, equal top-1, the cache really int8."""
    _, c0 = _cfgs(arch)
    c1 = dataclasses.replace(c0, kv_dtype="int8")
    m0 = build_model(c0, device="cpu").init(torch.Generator().manual_seed(0))
    m1 = build_model(c1, device="cpu")
    m1.load_state_dict(m0.state_dict())
    batch = {"tokens": np.random.default_rng(2).integers(
        0, c0.vocab, (2, 12)).astype(np.int32)}
    lg0, cc0 = m0.prefill(batch, cache_len=20)
    lg1, cc1 = m1.prefill(batch, cache_len=20)
    tok = lg0[:, -1].argmax(-1)[:, None]
    d0, _ = m0.decode_step(cc0, {"token": tok, "pos": 12})
    d1, _ = m1.decode_step(cc1, {"token": tok, "pos": 12})
    assert float((d0 - d1).abs().max()) < 0.6
    assert torch.equal(d0[:, -1].argmax(-1), d1[:, -1].argmax(-1))
    assert any(t.dtype == torch.int8 for _, t in _flat(cc1))


def _int8_flips(got, want, msg):
    """Leaf for leaf: every int8 entry within one of the reference's, the
    float scales and states to TOL. Returns (entries off by one, int8
    entries)."""
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w], msg
    flips = total = 0
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == \
            str(b.dtype), (msg, path)
        if b.dtype == np.int8:
            d = np.abs(a.numpy().astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1, (msg, path)
            flips += int((d == 1).sum())
            total += d.size
        else:
            _close(a, b, f"{msg} {path}")
    return flips, total


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_logits_and_caches_match_reference(arch):
    """Port int8 against reference int8 on the same parameters: a 12-token
    prefill (gemma3: 40, past its window), then 3 decode steps.

    Both sides quantize with the same formula, but of activations summed
    in another order, so an entry whose float32 value sits within an ulp
    of a rounding half can land one level apart (gemma3's 40-token prefill
    has one such entry among 28,800): every int8 entry must be within one
    of the reference's, and the entries off by one are counted, printed
    and held under 1e-3 of all. Such a flip moves a logit by up to ~3e-4,
    so each decode step runs the reference on the port's cache: logits,
    scales and float states to 1e-4, the step's new int8 entries within
    one."""
    s = 40 if arch == "gemma3-27b" else 12
    steps = 3
    cfg, rmodel, params, _, model = _ref_model(arch, kv_dtype="int8")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, s + steps),
                                             dtype=np.int32)
    lg_ref, c_ref = jax.jit(lambda p, bb: rmodel.prefill(
        p, bb, cache_len=s + steps))(params, {"tokens": toks[:, :s]})
    lg, c = model.prefill({"tokens": toks[:, :s]}, cache_len=s + steps)
    _close(lg, lg_ref, "prefill logits")
    flips, total = _int8_flips(c, c_ref, "prefill caches")
    treedef = jax.tree.structure(c_ref)
    step = jax.jit(rmodel.decode_step)
    for j in range(steps):
        tok = toks[:, s + j:s + j + 1]
        mine = jax.tree.unflatten(treedef, [jnp.asarray(t.numpy().copy())
                                            for _, t in _flat(c)])
        lg_ref, c_ref = step(params, mine,
                             {"token": tok,
                              "pos": jnp.asarray(s + j, jnp.int32)})
        lg, c = model.decode_step(c, {"token": tok, "pos": s + j})
        _close(lg, lg_ref, f"decode step {j} logits")
        n, _ = _int8_flips(c, c_ref, f"decode step {j} caches")
        flips += n
    print(f"{arch}: int8 entries off by one: {flips} of {total}")
    assert flips <= 1e-3 * total


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("arch", sorted(names()))
def test_every_config_builds_and_serves(arch, kv_dtype):
    """Every config's reduced variant, with a float and an int8 KV cache:
    built, a 16-token prefill and 2 decode steps, finite logits of the
    vocabulary's width."""
    _, cfg = _cfgs(arch, kv_dtype=kv_dtype)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)}
    if cfg.family == "encdec":
        batch = {"audio_embeds": rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32),
            "tokens": batch["tokens"][:, :2]}
    elif cfg.family == "vlm":
        batch = {"vision": rng.standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32),
            "tokens": batch["tokens"][:, :8]}
    lg, caches = model.prefill(batch, cache_len=18)
    for j in range(2):
        assert tuple(lg.shape) == (2, 1, cfg.vocab)
        assert bool(torch.isfinite(lg).all())
        lg, caches = model.decode_step(
            caches, {"token": lg[:, -1].argmax(-1)[:, None], "pos": 16 + j})
    assert bool(torch.isfinite(lg).all())
