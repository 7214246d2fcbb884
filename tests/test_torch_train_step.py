"""The port's training step against the reference, on the CPU: every
registered family's ``loss_fn`` and every parameter's gradient against
``jax.value_and_grad(model.loss_fn, has_aux=True)`` (mirroring
``tests/test_models.py::test_reduced_train_step``), the chunked cross
entropy (``tests/test_perf_knobs.py:14-37``), ``cfg.remat``, and serving
models keeping ``requires_grad`` off.

Reduced float32 configs. Parameters are drawn with numpy from a seed in
the reference's pytree layout (``jax.eval_shape`` of its ``init``: no
compile) and carried into the port with ``params_from_reference``; the
reference's gradient tree is mapped to the port's names the same way. Tolerances: the loss to rtol 1e-5; each gradient
tensor to ``‖g_port − g_ref‖ ≤ 1e-4 ‖g_ref‖`` (measured ≤ 4.3e-6: float32
sums in other orders), and elementwise within 1e-4 of the largest
reference entry of its tensor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs import names
from repro.models import build_model as ref_build
from repro.models.layers import chunked_ce as ref_chunked_ce
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan
from repro_torch.launch.steps import (make_decode_objects,
                                      make_prefill_objects)
from repro_torch.models import build_model, params_from_reference
from repro_torch.models.layers import chunked_ce, cross_entropy

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _batch(cfg, b=2, s=17, seed=0):
    """The reference test's batch (``tests/test_models.py::make_batch``)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    if cfg.family == "encdec":
        return {"audio_embeds": rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32), "tokens": toks[:, :9]}
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32), "tokens": toks}
    return {"tokens": toks}


def _models(arch, seed=0, **kw):
    """(reference model, params drawn for it, port model loaded with them,
    cfg): every leaf of the reference's parameter tree N(0, 0.1²) from
    ``seed``, in its dtype."""
    rcfg = dataclasses.replace(ref_get(arch).reduced(), **kw)
    cfg = dataclasses.replace(get(arch).reduced(), **kw)
    rmodel = ref_build(rcfg)
    shapes = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda sd: (0.1 * rng.standard_normal(sd.shape)).astype(sd.dtype),
        shapes)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, params))
    return rmodel, params, model, cfg


def _port_grads(model, batch):
    model.requires_grad_(True)
    loss, aux = model.loss_fn(batch)
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            {n: p.grad for n, p in model.named_parameters()})


def _grads_close(got, want, msg):
    assert sorted(got) == sorted(want), msg
    for name, g in got.items():
        assert g is not None, f"{msg}: {name} has no gradient"
        g, w = g.numpy(), want[name].numpy()
        assert g.shape == w.shape, (msg, name)
        err = np.linalg.norm(g - w)
        assert err <= GRAD_TOL * np.linalg.norm(w), (msg, name, err)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=f"{msg} {name}")


@pytest.mark.parametrize("arch", list(names()))
def test_loss_and_every_gradient_match_reference(arch):
    rmodel, params, model, cfg = _models(arch)
    batch = _batch(cfg)
    (rloss, raux), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss_fn, has_aux=True))(params, batch)
    loss, aux, grads = _port_grads(model, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    assert sorted(aux) == sorted(raux)
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(raux[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    want = params_from_reference(cfg, jax.tree.map(np.asarray, rgrads))
    _grads_close(grads, want, arch)


def test_steep_ssd_decay_keeps_gradients_finite():
    """Where a chunk's decay is steep enough that exp overflows above the
    diagonal (dt_bias 12: dt ~ 12 a step, 16-step chunks), the reference's
    einsum form has NaN gradients (0 · inf in the backward of its masked
    ``exp``); the port masks the exponent too: the same loss, every
    gradient finite."""
    rmodel, params, model, cfg = _models("mamba2-2.7b")
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(a, 12.0)
        if "dt_bias" in jax.tree_util.keystr(path) else a, params)
    model.load_state_dict(params_from_reference(cfg, params))
    batch = _batch(cfg)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss_fn, has_aux=True))(params, batch)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(rgrads))
    loss, _, grads = _port_grads(model, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize("s", [33, 30])
def test_chunked_ce_matches_plain_and_reference(s):
    """ce_chunk=4 equals the plain loss (the reference's bar, 2e-5), also
    for a ragged 30 = 4 chunks of 8 with 2 padded rows, and equals the
    reference's ``chunked_ce`` on the same inputs."""
    _, params, m0, cfg = _models("qwen3-0.6b")
    m1 = build_model(dataclasses.replace(cfg, ce_chunk=4), device="cpu")
    m1.load_state_dict(m0.state_dict())
    batch = {"tokens": np.random.default_rng(s).integers(
        0, cfg.vocab, (2, s)).astype(np.int32)}
    l0, _, g0 = _port_grads(m0, batch)
    l1, _, g1 = _port_grads(m1, batch)
    assert abs(float(l0) - float(l1)) < 2e-5
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, s)).astype(np.int32)
    want = ref_chunked_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                          4)
    got = chunked_ce(torch.from_numpy(h), torch.from_numpy(w),
                     torch.from_numpy(labels), 4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_chunked_ce_pads_with_zero_gradient():
    """The padded rows of a ragged last chunk carry no loss and no
    gradient: the gradient wrt h equals the unchunked loss's, row for
    row, and h's rows stay out of other rows' gradients."""
    rng = np.random.default_rng(2)
    h = torch.tensor(rng.standard_normal((2, 7, 8)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((8, 12)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 12, (2, 7)))
    chunked_ce(h, w, labels, 3).backward()
    got = h.grad.clone()
    h.grad = None
    cross_entropy(h @ w, labels).backward()
    np.testing.assert_allclose(got.numpy(), h.grad.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_cross_entropy_with_mask_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    for m in (None, mask):
        want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "zamba2-7b", "whisper-medium"])
def test_remat_gives_the_same_gradients(arch):
    """Recomputing each block in the backward pass (MoE routing included)
    changes no value: gradients with and without ``remat`` are equal."""
    _, _, m0, cfg = _models(arch, remat=False)
    m1 = build_model(dataclasses.replace(cfg, remat=True), device="cpu")
    m1.load_state_dict(m0.state_dict())
    batch = _batch(cfg)
    l0, _, g0 = _port_grads(m0, batch)
    l1, _, g1 = _port_grads(m1, batch)
    assert float(l0) == float(l1)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b",
                                  "whisper-medium"])
def test_serving_models_keep_gradients_off(arch):
    """A built model serves: no parameter requires grad, so prefill in
    grad mode reaches the kernels' route; a training model there is
    refused by the kernel guard instead of losing its gradients."""
    cfg = get(arch).reduced()
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    batch = _batch(cfg)
    logits, _ = model.prefill(batch)
    assert not logits.requires_grad
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        model.prefill(batch)
    with torch.no_grad():
        model.prefill(batch)


def test_kernel_guard_refuses_inputs_that_require_grad_on_the_cpu():
    """The guard holds on both devices, so a training route that reached
    B3, B4 or B5 fails here too, where the plain versions would have
    given it gradients."""
    q = torch.randn(2, 2, 8, 16, requires_grad=True)
    k = torch.randn(2, 8, 16)
    xc = torch.randn(2, 4, 2, 8, requires_grad=True)
    cum = torch.zeros(2, 4, 2)
    B = torch.randn(2, 4, 4)
    calls = [lambda: fa.flash_attention_folded(q, k, k, causal=True,
                                               window=0),
             lambda: da.decode_attention_folded(q[:, :, 0], k, k, 5),
             lambda: ssd_scan.ssd_intra_folded(xc, cum, B, B)]
    for call in calls:
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    with torch.no_grad():
        for call in calls:
            call()


def test_prefill_and_decode_builders():
    """``make_prefill_objects`` / ``make_decode_objects``: the cache grown
    to the shape's length, one decode step on it, shapes as specified."""
    cfg = get("qwen3-0.6b").reduced()
    shape = ShapeSpec("p", 24, 2, "prefill")
    model, prefill, specs = make_prefill_objects(cfg, shape, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    assert tuple(specs["tokens"].shape) == (2, 24)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    logits, caches = prefill({"tokens": toks})
    assert logits.shape == (2, 1, cfg.vocab)
    assert caches["k"].shape[2] == 24
    dmodel, decode, dspecs = make_decode_objects(
        cfg, ShapeSpec("d", 24, 2, "decode"), device="cpu")
    assert sorted(dspecs) == ["pos", "token"]
    dmodel.load_state_dict(model.state_dict())
    caches = dmodel.init_caches(2, 30)
    out, _ = decode(caches, {"token": toks[:, :1], "pos": 0})
    assert out.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(out).all())
