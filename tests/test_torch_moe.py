"""The port's MoE layer and MoE transformers against the reference, on
the CPU: routing (top-k order, renormalised probabilities, the switch aux
loss), dispatch ranks, ``moe_apply`` with every entry kept and above the
8,192-token line where a full expert drops entries, the parameter
carry-over (the float32 router of a bfloat16 model included), mixtral's
and arctic's prefill and decode, and mixtral's teacher-forced identity.

Configs: reduced mixtral-8x7b (4 experts, top 2, a uniform 32-token
window) and reduced arctic-480b (4 experts, top 2, the dense residual MLP),
float32, the reference with ``use_pallas`` off. Tolerance 1e-4 (rtol and
atol) as ``tests/test_torch_models.py``; ``top_i`` and ranks exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import build_model as ref_build
from repro.models import moe as ref_moe
from repro_torch.configs import get
from repro_torch.models import (TransformerLM, build_model, moe_apply,
                                params_from_reference)
from repro_torch.models import moe

TOL = 1e-4
ARCHS = ["mixtral-8x7b", "arctic-480b"]


def _cfgs(arch, **kw):
    return [dataclasses.replace(c.reduced(), **kw)
            for c in (ref_get(arch), get(arch))]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


def _moe_params(rcfg, cfg, seed=0):
    """One MoE layer's reference params and the port's ``MoE`` holding
    them."""
    tree = jax.tree.map(np.asarray, ref_moe.moe_init(
        jax.random.PRNGKey(seed), rcfg, jnp.float32))
    p = moe.MoE(cfg, torch.float32, torch.device("cpu"))
    p.load_state_dict({k: _t(v) for k, v in _flat(tree)})
    return tree, p


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _ref_model(arch, seed=0, **kw):
    rcfg, cfg = _cfgs(arch, **kw)
    rmodel = ref_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree))
    return cfg, rmodel, params, tree, model


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_ranks_match_reference(arch):
    """top_i exact (order included), probabilities and aux to 1e-4, dispatch
    ranks exact."""
    rcfg, cfg = _cfgs(arch)
    tree, p = _moe_params(rcfg, cfg)
    x = np.random.default_rng(1).standard_normal(
        (300, cfg.d_model)).astype(np.float32)
    pr, ir, ar = ref_moe._route({k: jnp.asarray(v) for k, v in tree.items()
                                 if k != "dense"}, jnp.asarray(x), rcfg)
    top_p, top_i, aux = moe._route(p, _t(x), cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ir))
    _close(top_p, pr)
    _close(aux, ar)
    np.testing.assert_array_equal(
        moe._dispatch_ranks(top_i, cfg.n_experts).numpy(),
        np.asarray(ref_moe._dispatch_ranks(ir, cfg.n_experts)))


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal logits: the lower expert first, as ``lax.top_k``; the ranks
    depend on that order."""
    _, cfg = _cfgs("mixtral-8x7b")
    p = {"router": torch.zeros(cfg.d_model, cfg.n_experts)}
    p["router"][0] = torch.tensor([1.0, 3.0, 3.0, 3.0])
    x = torch.zeros(5, cfg.d_model)
    x[:, 0] = 1.0
    _, top_i, _ = moe._route(p, x, cfg)
    _, want = jax.lax.top_k(jnp.asarray(np.tile([1.0, 3, 3, 3], (5, 1))), 2)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want))
    assert top_i[0].tolist() == [1, 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch):
    """2 × 37 tokens, every entry kept (capacity = tokens): output and aux
    to 1e-4; arctic adds its dense residual."""
    rcfg, cfg = _cfgs(arch)
    tree, p = _moe_params(rcfg, cfg, seed=2)
    assert ("dense" in p) == cfg.moe_dense_residual
    x = np.random.default_rng(3).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    yr, ar = ref_moe.moe_apply(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x), rcfg)
    y, aux = moe_apply(p, _t(x), cfg)
    _close(y, yr)
    _close(aux, ar)


def test_moe_apply_drops_entries_above_the_exact_line():
    """9,000 tokens (> 8,192) at d 64 with capacity_factor 0.5: capacity
    int(0.5 · 2 · 9000 / 4) = 2,250 per expert, so the latest entries of
    the busiest experts are dropped (they come back as zeros); the port
    drops the same ones and matches the reference to 1e-4."""
    rcfg, cfg = _cfgs("mixtral-8x7b", capacity_factor=0.5)
    tree, p = _moe_params(rcfg, cfg, seed=4)
    x = np.random.default_rng(5).standard_normal(
        (2, 4500, cfg.d_model)).astype(np.float32)
    t = 9000
    cap = moe.capacity(cfg, t)
    assert cap == 2250 < t
    _, top_i, _ = moe._route(p, _t(x).reshape(t, -1), cfg)
    ranks = moe._dispatch_ranks(top_i, cfg.n_experts)
    dropped = int((ranks >= cap).sum())
    assert dropped > 0
    yr, ar = ref_moe.moe_apply(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x), rcfg)
    y, aux = moe_apply(p, _t(x), cfg)
    _close(y, yr)
    _close(aux, ar)
    # a token whose both entries were dropped gets nothing from the experts
    both = (ranks >= cap).all(dim=1)
    if bool(both.any()):
        assert not y.reshape(t, -1)[both].any()


def test_a2a_dispatch_raises():
    """The a2a dispatch needs a device mesh (the reference asserts one);
    an unknown dispatch is refused. ``tests/test_torch_moe_a2a.py`` runs
    a2a over meshes."""
    _, cfg = _cfgs("mixtral-8x7b")
    with pytest.raises(ValueError, match="needs a device mesh"):
        TransformerLM(cfg, device="cpu", moe_impl="a2a")
    with pytest.raises(ValueError, match="needs a device mesh"):
        moe_apply(None, torch.zeros(1, 1, cfg.d_model), cfg, impl="a2a")
    with pytest.raises(ValueError, match="unknown moe_impl"):
        TransformerLM(cfg, device="cpu", moe_impl="gather")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip(arch):
    """Every reference array under ``blocks.<i>.``, nothing else; in a
    bfloat16 model the router stays float32 and the rest keeps its bits."""
    rcfg, cfg = _cfgs(arch, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ref_build(rcfg).init(
        jax.random.PRNGKey(1)))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree))
    sd = model.state_dict()
    assert sd["blocks.1.moe.router"].dtype == torch.float32
    assert sd["blocks.1.moe.wi"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["blocks.1.moe.router"].numpy(),
                                  tree["blocks"]["moe"]["router"][1])
    np.testing.assert_array_equal(
        sd["blocks.2.moe.wo"].float().numpy(),
        tree["blocks"]["moe"]["wo"][2].astype(np.float32))
    if cfg.moe_dense_residual:
        np.testing.assert_array_equal(
            sd["blocks.0.moe.dense.wg"].float().numpy(),
            tree["blocks"]["moe"]["dense"]["wg"][0].astype(np.float32))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_ref


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A 12-token prefill and 4 decode steps fed given tokens: logits and
    caches against the reference."""
    cfg, rmodel, params, _, model = _ref_model(arch)
    rng = np.random.default_rng(11)
    b, s, steps = 2, 12, 4
    toks = rng.integers(0, cfg.vocab, (b, s + steps), dtype=np.int32)
    lg_ref, c_ref = jax.jit(lambda p, bb: rmodel.prefill(
        p, bb, cache_len=s + steps))(params, {"tokens": toks[:, :s]})
    lg, c = model.prefill({"tokens": toks[:, :s]}, cache_len=s + steps)
    _close(lg, lg_ref, "prefill logits")
    step = jax.jit(rmodel.decode_step)
    for j in range(steps):
        tok = toks[:, s + j:s + j + 1]
        lg_ref, c_ref = step(params, c_ref,
                             {"token": tok,
                              "pos": jnp.asarray(s + j, jnp.int32)})
        lg, c = model.decode_step(c, {"token": tok, "pos": s + j})
        _close(lg, lg_ref, f"decode step {j} logits")
    for n in ("k", "v"):
        assert tuple(c[n].shape) == c_ref[n].shape
        _close(c[n], c_ref[n], f"cache {n}")


def test_mixtral_decode_matches_prefill_teacher_forced():
    """prefill(t[:k]) then decode t[k], ... reproduces the last-token
    logits of prefill(t[:k+j]) (the reference's own test and tolerance,
    2e-3)."""
    _, cfg = _cfgs("mixtral-8x7b")
    model = TransformerLM(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    b, k, extra = 2, 12, 4
    toks = rng.integers(0, cfg.vocab, (b, k + extra), dtype=np.int32)
    logits, caches = model.prefill({"tokens": toks[:, :k]},
                                   cache_len=k + extra)
    dec = [logits[:, -1]]
    for j in range(extra):
        logits, caches = model.decode_step(
            caches, {"token": toks[:, k + j:k + j + 1], "pos": k + j})
        dec.append(logits[:, -1])
    for j in range(extra + 1):
        want, _ = model.prefill({"tokens": toks[:, :k + j]},
                                cache_len=k + extra)
        np.testing.assert_allclose(dec[j].numpy(), want[:, -1].numpy(),
                                   atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {j}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_returns_the_aux_loss(arch):
    """``forward`` sums the layers' aux losses as the reference's does."""
    cfg, rmodel, params, _, model = _ref_model(arch)
    batch = {"tokens": np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 10), dtype=np.int32)}
    _, _, aux_ref = rmodel.forward(params, batch)
    _, _, aux = model.forward(batch)
    _close(aux, aux_ref)
