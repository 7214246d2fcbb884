"""The port's enc-dec model (whisper's backbone) against the reference, on
the CPU: the sinusoid, cross attention (two kv chunks of the reference's
chunked softmax), the encoder, the prefill's self and cross caches, four
decode steps, and the serving loop's tokens, whose decode positions start
at the encoder's length as the reference's do.

Config: reduced whisper-medium (2 + 2 layers, d_model 64, 4 query and 2
kv heads of 16, gelu MLPs), float32, the reference with ``use_pallas``
off. Tolerance 1e-4 (rtol and atol), as ``tests/test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.launch.serve import Server as RefServer
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import encdec as ref_encdec
from repro_torch.configs import get
from repro_torch.launch import serve
from repro_torch.models import (EncDecLM, build_model, cross_attn_apply,
                                cross_kv, params_from_reference)
from repro_torch.models import encdec

TOL = 1e-4
ARCH = "whisper-medium"


def _cfgs(**kw):
    return [dataclasses.replace(c.reduced(), **kw)
            for c in (ref_get(ARCH), get(ARCH))]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


def _ref_model(seed=0, **kw):
    rcfg, cfg = _cfgs(**kw)
    rmodel = ref_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree))
    return cfg, rmodel, params, tree, model


def _batch(cfg, b=2, frames=24, n_tok=5, seed=0):
    rng = np.random.default_rng(seed)
    return {"audio_embeds": rng.standard_normal(
        (b, frames, cfg.d_model)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab, (b, n_tok), dtype=np.int32)}


def test_model_and_parameters():
    """``build_model`` gives ``EncDecLM``; every reference array lands under
    its name and index, nothing else."""
    cfg, _, _, tree, model = _ref_model()
    assert isinstance(model, EncDecLM)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["dec_blocks.1.xattn.wk"].numpy(),
                                  tree["dec_blocks"]["xattn"]["wk"][1])
    np.testing.assert_array_equal(sd["enc_blocks.0.mlp.wi"].numpy(),
                                  tree["enc_blocks"]["mlp"]["wi"][0])
    np.testing.assert_array_equal(sd["dec_pos"].numpy(), tree["dec_pos"])
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_ref


@pytest.mark.parametrize("s,d", [(24, 64), (1500, 1024)])
def test_sinusoid_matches_reference(s, d):
    _close(encdec._sinusoid(s, d, torch.float32, torch.device("cpu")),
           ref_encdec._sinusoid(s, d, jnp.float32))


@pytest.mark.parametrize("frames", [24, 1500])
def test_cross_attention_matches_reference(frames):
    """Queries against the encoder's frames, no mask: one kv chunk, and
    1,500 frames in the reference's two chunks (1,024 + 476)."""
    cfg, _, _, tree, model = _ref_model()
    rcfg = _cfgs()[0]
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, frames, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         tree["dec_blocks"]["xattn"])
    p = model.dec_blocks[0].xattn
    kr, vr = ref_attn.cross_kv(p_ref, jnp.asarray(enc), rcfg)
    k, v = cross_kv(p, _t(enc))
    _close(k, kr)
    _close(v, vr)
    _close(cross_attn_apply(p, _t(x), k, v, cfg),
           ref_attn.cross_attn_apply(p_ref, jnp.asarray(x), kr, vr, rcfg))


def test_encode_matches_reference():
    """The bidirectional encoder (sinusoid + RoPE'd self-attention)."""
    cfg, rmodel, params, _, model = _ref_model()
    batch = _batch(cfg)
    _close(model.encode(batch["audio_embeds"]),
           jax.jit(rmodel.encode)(params, batch["audio_embeds"]))


def test_prefill_and_decode_match_reference():
    """24 frames, 5 decoder tokens: prefill logits, self caches grown to 28
    slots and per-layer cross caches, then 4 decode steps at positions
    5..8, logits and final caches."""
    cfg, rmodel, params, _, model = _ref_model()
    batch = _batch(cfg)
    s, steps = 5, 4
    lg_ref, c_ref = jax.jit(lambda p, bb: rmodel.prefill(
        p, bb, cache_len=s + steps + 19))(params, batch)
    lg, c = model.prefill(batch, cache_len=s + steps + 19)
    _close(lg, lg_ref, "prefill logits")
    for part in ("self", "cross"):
        for n in ("k", "v"):
            assert tuple(c[part][n].shape) == c_ref[part][n].shape
            _close(c[part][n], c_ref[part][n], f"prefill {part} {n}")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, steps),
                                             dtype=np.int32)
    step = jax.jit(rmodel.decode_step)
    for j in range(steps):
        tok = toks[:, j:j + 1]
        lg_ref, c_ref = step(params, c_ref,
                             {"token": tok,
                              "pos": jnp.asarray(s + j, jnp.int32)})
        lg, c = model.decode_step(c, {"token": tok, "pos": s + j})
        _close(lg, lg_ref, f"decode step {j} logits")
    for n in ("k", "v"):
        _close(c["self"][n], c_ref["self"][n], f"decode self {n}")


def test_init_caches_match_reference_layout():
    rcfg, cfg = _cfgs()
    want = ref_build(rcfg).init_caches(2, 20)
    got = EncDecLM(cfg, device="cpu").init_caches(2, 20)
    for part in ("self", "cross"):
        for n in ("k", "v"):
            assert tuple(got[part][n].shape) == want[part][n].shape
            assert not got[part][n].any()
    assert got["cross"]["k"].shape[2] == encdec.CROSS_FRAMES


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_server_generate_matches_reference_server(kv_dtype):
    """The reference ``main``'s batch for whisper (``request_batch``): 16
    frames and 16 // 8 = 2 decoder tokens, 6 new tokens, no EOS. Both
    servers decode at positions 16.. (the encoder's length), so self-cache
    slots 2..15 stay zero and are attended: the same tokens, with the float
    and the int8 self cache."""
    rcfg, cfg = _cfgs(kv_dtype=kv_dtype)
    ref_srv = RefServer(rcfg, batch=2, prompt_len=16, max_new=6, eos_id=-1)
    tree = jax.tree.map(np.asarray, ref_srv.init_params(0))
    batch = serve.request_batch(cfg, 2, 16, np.random.default_rng(0))
    assert batch["audio_embeds"].shape == (2, 16, cfg.d_model)
    assert batch["tokens"].shape == (2, 2)
    want = ref_srv.generate(tree, batch)
    srv = serve.Server(cfg, batch=2, prompt_len=16, max_new=6, eos_id=-1,
                       device="cpu")
    srv.model.load_state_dict(params_from_reference(cfg, tree))
    got = srv.generate(batch)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens_generated"] == want["tokens_generated"] == 12
