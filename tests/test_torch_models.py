"""The port's dense serving model against the reference, on the CPU:
layers, the parameter carry-over, attention prefill / decode (the
reference with and without its Pallas kernels), ``TransformerLM`` prefill
logits and caches and four decode steps on the same parameters, and the
port's own teacher-forced identity.

Configs: reduced qwen3-0.6b (qk-norm, swiglu, tied embeddings), reduced
starcoder2-3b (gelu, untied), reduced qwen3 with a uniform sliding
window of 8 (ring caches), and two that keep what ``reduced()`` drops:
reduced gemma-7b (geglu, tied) at its served head_dim of 256 with 2
layers, and reduced starcoder2-3b at its served 12 query heads a kv head
(24 q / 2 kv heads of 16); all float32. Tolerance 1e-4 (rtol and atol) on
activations, caches and logits: XLA and torch sum the matmuls in another
order, and the reduced models have logits of order 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get as ref_get
from repro.configs import names
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import model_flops as ref_flops
from repro.models import param_count as ref_params
from repro.models import supports_shape as ref_supports
from repro_torch.configs import SHAPES, get
from repro_torch.models import (TransformerLM, attn_decode, attn_prefill,
                                grow_cache, mlp_apply,
                                model_flops, param_count,
                                params_from_reference, rms_norm, rope,
                                supports_shape)

TOL = 1e-4
#: reduced configs with what each suffix puts back
VARIANTS = {"-window8": dict(window=8),
            "-hd256": dict(head_dim=256, n_layers=2),
            "-g12": dict(n_heads=24, n_kv_heads=2)}
ARCHS = ["qwen3-0.6b", "starcoder2-3b", "qwen3-0.6b-window8",
         "gemma-7b-hd256", "starcoder2-3b-g12"]


def _cfgs(arch):
    """(reference cfg, port cfg), reduced and float32, with the variant's
    fields put back."""
    for suffix, kw in VARIANTS.items():
        if arch.endswith(suffix):
            base = arch.removesuffix(suffix)
            return [dataclasses.replace(c, **kw) for c in (
                ref_get(base).reduced(), get(base).reduced())]
    return [ref_get(arch).reduced(), get(arch).reduced()]


def _ref_model(arch, seed=0):
    rcfg, cfg = _cfgs(arch)
    rmodel = ref_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree))
    return rcfg, cfg, rmodel, params, tree, model


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    """(1 + scale) scaling in float32, cast back (bfloat16 too)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(rms_norm(_t(x), _t(scale), 1e-6),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    got = rms_norm(_t(x).bfloat16(), _t(scale).bfloat16())
    want = ref_layers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(scale, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    """Half-split rotation at absolute positions (decode's single position
    included)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(rope(_t(x), _t(pos), theta),
           ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    one = np.full((2, 1), 2047, np.int32)
    _close(rope(_t(x[:, :1]), _t(one), theta),
           ref_layers.rope(jnp.asarray(x[:, :1]), jnp.asarray(one), theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_reference(act):
    rng = np.random.default_rng(2)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.1 for n, s in
         (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    if act == "gelu":
        del p["wg"]
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    _close(mlp_apply({n: _t(a) for n, a in p.items()}, _t(x), act),
           ref_layers.mlp_apply({n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x), act))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip(arch):
    """Every reference array lands in the state dict unchanged, layer i of
    a stacked array under ``blocks.<i>.``, and nothing else is there."""
    _, cfg, _, _, tree, model = _ref_model(arch)
    sd = model.state_dict()
    seen = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if path[0] == "blocks":
            for i in range(cfg.n_layers):
                name = f"blocks.{i}." + ".".join(path[1:])
                np.testing.assert_array_equal(sd[name].numpy(), node[i])
                seen.add(name)
        else:
            np.testing.assert_array_equal(sd[path[0]].numpy(), node)
            seen.add(path[0])

    walk(tree, ())
    assert seen == set(sd)


def test_params_from_reference_keeps_bfloat16_bits():
    rcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in _cfgs("qwen3-0.6b"))
    tree = jax.tree.map(np.asarray,
                        ref_build(rcfg).init(jax.random.PRNGKey(3)))
    sd = params_from_reference(cfg, tree)
    assert sd["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_and_decode_match_reference(arch, use_pallas):
    """Layer 0's attention: prefill output and cache, then the cache grown
    to serving length and one decode step at the next position."""
    rcfg, cfg, _, _, tree, model = _ref_model(arch)
    rcfg = dataclasses.replace(rcfg, use_pallas=use_pallas)
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["attn"])
    p = model.blocks[0].attn
    is_global = cfg.window == 0
    rng = np.random.default_rng(7)
    b, s, cache_len = 2, 12, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    y_ref, c_ref = ref_attn.attn_prefill(p_ref, jnp.asarray(x),
                                         jnp.asarray(pos), rcfg, is_global,
                                         with_cache=True)
    y, c = attn_prefill(p, _t(x), _t(np.ascontiguousarray(pos)), cfg,
                        is_global, with_cache=True)
    _close(y, y_ref, "prefill out")
    for n in ("k", "v"):
        _close(c[n], c_ref[n], f"prefill cache {n}")
    c_ref = ref_attn.grow_cache(c_ref, rcfg, is_global, cache_len, s)
    c = grow_cache(c, cfg, is_global, cache_len, s)
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    y_ref, c_ref = ref_attn.attn_decode(p_ref, jnp.asarray(x1), c_ref,
                                        jnp.asarray(s, jnp.int32), rcfg,
                                        is_global)
    y, c = attn_decode(p, _t(x1), c, s, cfg, is_global)
    _close(y, y_ref, "decode out")
    for n in ("k", "v"):
        assert c[n].shape == c_ref[n].shape
        _close(c[n], c_ref[n], f"decode cache {n}")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and grown caches, then 4 decode steps fed given
    tokens, against the reference on the converted parameters."""
    _, cfg, rmodel, params, _, model = _ref_model(arch)
    rng = np.random.default_rng(11)
    b, s, steps = 2, 12, 4
    cache_len = s + steps
    toks = rng.integers(0, cfg.vocab, (b, s + steps), dtype=np.int32)
    lg_ref, c_ref = jax.jit(lambda p, bb: rmodel.prefill(
        p, bb, cache_len=cache_len))(params, {"tokens": toks[:, :s]})
    lg, c = model.prefill({"tokens": toks[:, :s]}, cache_len=cache_len)
    assert lg.shape == (b, 1, cfg.vocab)
    _close(lg, lg_ref, "prefill logits")
    for n in ("k", "v"):
        assert c[n].shape == c_ref[n].shape
        _close(c[n], c_ref[n], f"prefill cache {n}")
    step = jax.jit(rmodel.decode_step)
    for j in range(steps):
        tok = toks[:, s + j:s + j + 1]
        lg_ref, c_ref = step(params, c_ref,
                             {"token": tok, "pos": jnp.asarray(s + j,
                                                               jnp.int32)})
        lg, c = model.decode_step(c, {"token": tok, "pos": s + j})
        _close(lg, lg_ref, f"decode step {j} logits")
    for n in ("k", "v"):
        _close(c[n], c_ref[n], f"decode cache {n}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_teacher_forced(arch):
    """prefill(t[:k]) then decode t[k], t[k+1], ... reproduces the
    last-token logits of prefill(t[:k+j]): the cache is the sequence (ring
    caches included). Tolerance as the reference's own test, 2e-3."""
    _, cfg = _cfgs(arch)
    model = TransformerLM(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    b, k, extra = 2, 12, 4
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
                                   err_msg=f"{arch} step {j}")


def test_init_caches_match_reference_layout():
    rcfg, cfg = _cfgs("qwen3-0.6b-window8")
    want = ref_build(rcfg).init_caches(2, 20)
    got = TransformerLM(cfg, device="cpu").init_caches(2, 20)
    for n in ("k", "v"):
        assert tuple(got[n].shape) == want[n].shape
        assert not got[n].any()


# ---------------------------------------------------------------------------
# model_zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(names()) + ARCHS[3:])
def test_counts_match_reference(arch):
    """Every registered config at its published widths, and the reduced
    variants that keep gemma-7b's head_dim and starcoder2-3b's 12 query
    heads a kv head."""
    rcfg, cfg = (ref_get(arch), get(arch)) if arch in names() \
        else _cfgs(arch)
    for shape, rshape in zip(SHAPES, REF_SHAPES):
        assert supports_shape(cfg, shape) == ref_supports(rcfg, rshape)
        assert model_flops(cfg, shape) == ref_flops(rcfg, rshape)
    for active in (False, True):
        assert param_count(cfg, active) == ref_params(rcfg, active)


def test_qwen3_full_width_counts():
    """The served model: 596 M matrix parameters (norm scales aside) with
    the embedding tied, 1.19 GB in bfloat16."""
    n = param_count(get("qwen3-0.6b"))
    assert n == 151_936 * 1024 + 28 * (1024 * 128 * (16 + 8) * 2
                                       + 3 * 1024 * 3072)
    assert round(n / 1e6) == 596
