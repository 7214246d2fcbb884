"""The port's optimiser and gradient compression against the reference,
on the CPU: mirrors ``tests/test_substrate.py:27-110`` (AdamW on a
quadratic, clipping, the schedule, int8 bounds and error feedback), then
one ``adamw_update`` and ``quantize_int8`` against the reference's on the
same numpy-drawn inputs.

Tolerances: ``quantize_int8`` bit for bit (both divide in float32 and
round half to even). One AdamW step on float32 tensors: parameters and
moments to rtol 1e-6 with an atol of 1e-6 of the tensor's largest entry
(the clipping norm sums in another order, the learning rate's ``cos`` and
the bias corrections' ``pow`` come from other libraries: each may differ
in the last ulp, and a moment near zero after cancellation carries that
ulp as a larger relative error). On bfloat16 parameters the float32 update
is rounded to bfloat16, where such an ulp can flip a rounding: parameters
within one bfloat16 ulp (rtol 2**-7).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro.optim.compression import compress_error_feedback as ref_compress
from repro.optim.compression import init_compression as ref_init_compression
from repro.optim.compression import quantize_int8 as ref_quantize_int8
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_error_feedback, cosine_schedule,
                               dequantize_int8, global_norm, init_compression,
                               quantize_int8)

# ---------------------------------------------------------------------------
# mirrors of the reference's tests
# ---------------------------------------------------------------------------


def test_adamw_converges_quadratic():
    w = torch.full((8, 8), 3.0, requires_grad=True)
    params = {"w": w}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.2, warmup_steps=5, total_steps=100,
                      weight_decay=0.0)
    l0 = float(torch.sum(w.detach() ** 2))
    for _ in range(60):
        w.grad = None
        torch.sum(w ** 2).backward()
        params, state, _ = adamw_update({"w": w.grad}, state, params, cfg)
    assert float(torch.sum(w.detach() ** 2)) < 1e-2 * l0
    assert int(state.count) == 60 and state.count.dtype == torch.int32


def test_grad_clip_applied():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, total_steps=10)
    g = {"w": torch.full((4,), 100.0)}
    _, _, m = adamw_update(g, state, params, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm(g)) == pytest.approx(200.0)
    # the moments saw the clipped gradient, 100 / 200 per entry
    np.testing.assert_allclose(state.mu["w"].numpy(), 0.1 * 0.5, rtol=1e-6)


def test_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(1.0)
    assert lrs[-1] == pytest.approx(0.1, rel=1e-2)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))
    rcfg = RefAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    want = [float(ref_cosine_schedule(rcfg, jnp.asarray(s)))
            for s in range(0, 101, 10)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_int8_quantization_bounded_error(seed):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        256).astype(np.float32))
    q, scale = quantize_int8(g)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, scale) - g).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-7


def test_error_feedback_preserves_signal():
    """Sum of decompressed grads over steps tracks the true sum (the
    residual never grows unboundedly)."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64, np.float32)
    sent_sum = np.zeros(64, np.float32)
    state = init_compression({"g": torch.zeros(64)})
    for _ in range(50):
        g = rng.standard_normal(64).astype(np.float32)
        true_sum += g
        out, state = compress_error_feedback({"g": torch.from_numpy(g)},
                                             state)
        sent_sum += out["g"].numpy()
    resid = state.error["g"].numpy()
    np.testing.assert_allclose(sent_sum + resid, true_sum, atol=1e-3)
    assert np.abs(resid).max() < 0.2      # residual stays one-quantum sized


# ---------------------------------------------------------------------------
# against the reference on the same inputs
# ---------------------------------------------------------------------------

def _tree(seed, dtype):
    """{name: array}: a matrix, a vector and a scalar-sized leaf."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 5)).astype(dtype),
            "b": rng.standard_normal(7).astype(dtype),
            "c": rng.standard_normal(1).astype(dtype)}


def _torch(tree):
    return {n: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else torch.float32)
        for n, a in tree.items()}


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_adamw_update_matches_reference(dtype):
    """Three steps from a state part way through warmup, clipping on: the
    parameters, both moments, the count, the norm and the lr."""
    params = _tree(0, dtype)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               clip_norm=1.0)
    rstate = ref_adamw_init(jax.tree.map(jnp.asarray, params))
    rparams = jax.tree.map(jnp.asarray, params)
    tparams = _torch(params)
    tstate = adamw_init(tparams)
    for i in range(3):
        grads = _tree(10 + i, dtype)
        rparams, rstate, rm = ref_adamw_update(
            jax.tree.map(jnp.asarray, grads), rstate, rparams,
            RefAdamWConfig(**cfg))
        tparams, tstate, tm = adamw_update(_torch(grads), tstate, tparams,
                                           AdamWConfig(**cfg))
    assert int(tstate.count) == int(rstate.count) == 3
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
    prtol = 2.0 ** -7 if dtype is ml_dtypes.bfloat16 else 1e-6
    for n in params:
        assert tparams[n].dtype == (torch.bfloat16 if dtype is
                                    ml_dtypes.bfloat16 else torch.float32)
        np.testing.assert_allclose(tparams[n].float().numpy(),
                                   np.asarray(rparams[n], np.float32),
                                   rtol=prtol, atol=1e-7, err_msg=n)
        for got, want in ((tstate.mu, rstate.mu), (tstate.nu, rstate.nu)):
            assert got[n].dtype == torch.float32
            w = np.asarray(want[n])
            np.testing.assert_allclose(got[n].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=n)


@pytest.mark.parametrize("seed", range(3))
def test_quantize_int8_bit_for_bit(seed):
    """Values at rounding halves included (k + 0.5 quanta)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(4096).astype(np.float32) * 3
    g[:64] = (np.arange(64) - 32 + 0.5) * (np.abs(g).max() / 127)
    q, scale = quantize_int8(torch.from_numpy(g))
    rq, rscale = ref_quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)


def test_error_feedback_matches_reference():
    """Ten rounds of compression on float32 and bfloat16 gradients: the
    wire values bit for bit, the residual bit for bit."""
    shapes = {"a": (33, 4), "b": (5,)}
    rng = np.random.default_rng(4)
    state = init_compression({n: torch.zeros(s) for n, s in shapes.items()})
    rstate = ref_init_compression({n: jnp.zeros(s)
                                   for n, s in shapes.items()})
    for _ in range(10):
        grads = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
                 "b": rng.standard_normal(shapes["b"]).astype(
                     ml_dtypes.bfloat16)}
        out, state = compress_error_feedback(_torch(grads), state)
        rout, rstate = ref_compress(jax.tree.map(jnp.asarray, grads), rstate)
        for n in shapes:
            np.testing.assert_array_equal(out[n].float().numpy(),
                                          np.asarray(rout[n], np.float32))
            np.testing.assert_array_equal(state.error[n].numpy(),
                                          np.asarray(rstate.error[n]))
