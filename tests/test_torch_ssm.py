"""The port's Mamba2 blocks and SSM / hybrid models against the reference,
on the CPU: the chunked SSD (against the reference's ``ssd_chunked``, with
and without its Pallas kernel in interpret mode, and both packages'
sequential oracles), ``mamba_seq`` and ``mamba_decode`` on carried-over
parameters, ``MambaLM`` and ``Zamba2LM`` prefill logits, states and caches
and four decode steps, the port's own teacher-forced identity, the
parameter carry-over, and construction and counts for both families.

Configs: reduced mamba2-2.7b (4 blocks, d_model 64, 8 SSM heads of 16,
state 16, chunk 16) and reduced zamba2-7b (2 groups of 2 blocks, each
followed by the shared attention, plus 1 tail block), float32, the
reference with ``use_pallas`` off. Prompts of 21 tokens leave a ragged
last chunk. Tolerance 1e-4 (rtol and atol), as in
``tests/test_torch_models.py``: XLA and torch sum in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import build_model as ref_build
from repro.models import ssm as ref_ssm
from repro_torch.configs import get
from repro_torch.models import (MambaLM, Zamba2LM, build_model, param_count,
                                params_from_reference)
from repro_torch.models import ssm

TOL = 1e-4
ARCHS = ["mamba2-2.7b", "zamba2-7b"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


def _ref_model(arch, seed=0):
    rcfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
    rmodel = ref_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree))
    return rcfg, cfg, rmodel, params, tree, model


def _leaves(caches):
    return jax.tree.leaves(caches, is_leaf=lambda t: isinstance(
        t, torch.Tensor))


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = np.exp(-np.abs(rng.standard_normal((b, s, h))) * 0.2).astype(
        np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xdt, a, B, C, h0


@pytest.mark.parametrize("s,chunk,with_h0", [
    (32, 16, False), (37, 16, True),     # two chunks; ragged, carried state
    (5, 16, True),                       # one chunk shorter than `chunk`
])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    """Outputs and final state against the reference's chunked SSD (its
    XLA path and its Pallas kernel in interpret mode) and both packages'
    sequential oracles."""
    xdt, a, B, C, h0 = _ssd_inputs(2, s, 3, 8, 4, s)
    h0 = h0 if with_h0 else None
    y, hT = ssm.ssd_chunked(_t(xdt), _t(a), _t(B), _t(C), chunk,
                            h0=None if h0 is None else _t(h0))
    assert y.shape == (2, s, 3, 8) and hT.shape == (2, 3, 8, 4)
    jin = [jnp.asarray(v) for v in (xdt, a, B, C)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    for use_pallas in (False, True):
        y_ref, h_ref = ref_ssm.ssd_chunked(*jin, chunk, h0=jh0,
                                           use_pallas=use_pallas)
        _close(y, y_ref, f"y use_pallas={use_pallas}")
        _close(hT, h_ref, f"state use_pallas={use_pallas}")
    y_seq, h_seq = ref_ssm.ssd_sequential(*jin, h0=jh0)
    _close(y, y_seq, "y vs reference sequential")
    _close(hT, h_seq, "state vs reference sequential")
    y_own, h_own = ssm.ssd_sequential(_t(xdt), _t(a), _t(B), _t(C),
                                      h0=None if h0 is None else _t(h0))
    _close(y_own, y_seq, "port sequential")
    _close(h_own, h_seq, "port sequential state")


def test_ssd_chunked_underflowed_decay_is_clamped():
    """A decay that underflows to 0 is clamped to 1e-30 before its log, as
    in the reference: the state entering the next chunk is forgotten, and
    nothing is NaN."""
    xdt, a, B, C, _ = _ssd_inputs(1, 32, 2, 4, 4, 1)
    a[:, 17] = 0.0
    y, hT = ssm.ssd_chunked(_t(xdt), _t(a), _t(B), _t(C), 16)
    y_ref, h_ref = ref_ssm.ssd_chunked(*(jnp.asarray(v)
                                         for v in (xdt, a, B, C)), 16)
    assert bool(torch.isfinite(y).all())
    _close(y, y_ref)
    _close(hT, h_ref)


# ---------------------------------------------------------------------------
# mamba2 blocks on carried-over parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_pair():
    rcfg, cfg, _, _, tree, model = _ref_model("mamba2-2.7b")
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[1]),
                         tree["blocks"]["mamba"])
    return rcfg, cfg, p_ref, model.blocks[1].mamba


def test_mamba_seq_and_decode_match_reference(mamba_pair):
    """A 21-token sequence from given states (two chunks, the second
    ragged), then two single-token steps: outputs and both states."""
    rcfg, cfg, p_ref, p = mamba_pair
    rng = np.random.default_rng(2)
    b, s = 2, 21
    conv0 = rng.standard_normal((b, cfg.ssm_conv - 1, cfg.d_inner
                                 + 2 * cfg.ssm_state)).astype(np.float32)
    ssm0 = rng.standard_normal((b, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state)).astype(np.float32) * 0.1
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    y_ref, (c_ref, s_ref) = ref_ssm.mamba_seq(
        p_ref, jnp.asarray(x), rcfg, jnp.asarray(conv0), jnp.asarray(ssm0))
    y, (c, st) = ssm.mamba_seq(p, _t(x), cfg, _t(conv0), _t(ssm0))
    _close(y, y_ref, "seq out")
    _close(c, c_ref, "seq conv state")
    _close(st, s_ref, "seq ssm state")
    for j in range(2):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        y_ref, (c_ref, s_ref) = ref_ssm.mamba_decode(
            p_ref, jnp.asarray(x1), rcfg, c_ref, s_ref)
        c_in, st_in = c.clone(), st.clone()
        y, (c, st) = ssm.mamba_decode(p, _t(x1), cfg, c, st)
        _close(y, y_ref, f"decode {j} out")
        _close(c, c_ref, f"decode {j} conv state")
        _close(st, s_ref, f"decode {j} ssm state")
        assert not torch.equal(st, st_in) and c.shape == c_in.shape


def test_conv_state_is_the_last_raw_inputs():
    """The conv state after a sequence is its last k-1 inputs before bias
    and silu, and a step from it equals the step inside the sequence."""
    rng = np.random.default_rng(4)
    xBC = torch.from_numpy(rng.standard_normal((2, 9, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    out, state = ssm._conv1d_causal(xBC, w, bias)
    assert torch.equal(state, xBC[:, -3:])
    head, st8 = ssm._conv1d_causal(xBC[:, :8], w, bias)
    last, _ = ssm._conv1d_causal(xBC[:, 8:], w, bias, st8)
    torch.testing.assert_close(torch.cat([head, last], 1), out)


# ---------------------------------------------------------------------------
# the whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and every state and cache (KV caches grown to the
    serving length), then 4 decode steps fed given tokens, logits and
    every state and cache after them."""
    _, cfg, rmodel, params, _, model = _ref_model(arch)
    rng = np.random.default_rng(11)
    b, s, steps = 2, 21, 4
    cache_len = s + steps
    toks = rng.integers(0, cfg.vocab, (b, s + steps), dtype=np.int32)
    lg_ref, c_ref = jax.jit(lambda p, bb: rmodel.prefill(
        p, bb, cache_len=cache_len))(params, {"tokens": toks[:, :s]})
    with torch.inference_mode():
        lg, c = model.prefill({"tokens": toks[:, :s]}, cache_len=cache_len)
    assert lg.shape == (b, 1, cfg.vocab)
    _close(lg, lg_ref, "prefill logits")
    want, got = jax.tree.leaves(c_ref), _leaves(c)
    assert [w.shape for w in want] == [tuple(g.shape) for g in got]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"prefill cache leaf {i}")
    step = jax.jit(rmodel.decode_step)
    for j in range(steps):
        tok = toks[:, s + j:s + j + 1]
        lg_ref, c_ref = step(params, c_ref, {
            "token": tok, "pos": jnp.asarray(s + j, jnp.int32)})
        with torch.inference_mode():
            lg, c = model.decode_step(c, {"token": tok, "pos": s + j})
        _close(lg, lg_ref, f"decode step {j} logits")
    for i, (g, w) in enumerate(zip(_leaves(c), jax.tree.leaves(c_ref))):
        _close(g, w, f"decode cache leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_teacher_forced(arch):
    """prefill(t[:k]) then decode t[k], t[k+1], ... reproduces the
    last-token logits of prefill(t[:k+j]): the one-step recurrence carries
    what the chunked prefill computes. Tolerance as the reference's own
    test, 2e-3."""
    cfg = get(arch).reduced()
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    b, k, extra = 2, 14, 4                  # crosses the chunk edge at 16
    toks = rng.integers(0, cfg.vocab, (b, k + extra), dtype=np.int32)
    cache = k + extra
    with torch.inference_mode():
        logits, caches = model.prefill({"tokens": toks[:, :k]},
                                       cache_len=cache)
        dec = [logits[:, -1]]
        for j in range(extra):
            logits, caches = model.decode_step(
                caches, {"token": toks[:, k + j:k + j + 1], "pos": k + j})
            dec.append(logits[:, -1])
        for j in range(extra + 1):
            want, _ = model.prefill({"tokens": toks[:, :k + j]},
                                    cache_len=cache)
            np.testing.assert_allclose(dec[j].numpy(), want[:, -1].numpy(),
                                       atol=2e-3, rtol=2e-3,
                                       err_msg=f"{arch} step {j}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference_layout(arch):
    rcfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
    want = jax.tree.leaves(ref_build(rcfg).init_caches(2, 20))
    got = _leaves(build_model(cfg, device="cpu").init_caches(2, 20))
    assert [w.shape for w in want] == [tuple(g.shape) for g in got]
    assert [str(w.dtype) for w in want] == [str(g.dtype)[6:] for g in got]
    assert not any(g.any() for g in got)


# ---------------------------------------------------------------------------
# parameters, construction, counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip(arch):
    """Every reference array lands in the state dict unchanged, a stacked
    block under its indices, and nothing else is there."""
    _, cfg, _, _, tree, model = _ref_model(arch)
    sd = model.state_dict()
    seen = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        lead = {"blocks": 1, "groups": 2, "tail": 1}.get(path[0], 0)
        for idx in np.ndindex(*node.shape[:lead]):
            name = ".".join([path[0], *map(str, idx), *path[1:]])
            np.testing.assert_array_equal(sd[name].numpy(), node[idx])
            seen.add(name)

    walk(tree, ())
    assert seen == set(sd)


def test_params_from_reference_keeps_float32_ssm_scalars():
    """In a bfloat16 model A_log, D and dt_bias stay float32; the rest
    keeps its bfloat16 bits."""
    rcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in (
        ref_get("mamba2-2.7b").reduced(), get("mamba2-2.7b").reduced()))
    tree = jax.tree.map(np.asarray,
                        ref_build(rcfg).init(jax.random.PRNGKey(3)))
    sd = params_from_reference(cfg, tree)
    for name in ("A_log", "D", "dt_bias"):
        assert sd[f"blocks.0.mamba.{name}"].dtype == torch.float32
    assert sd["blocks.2.mamba.wx"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sd["blocks.2.mamba.wx"].float().numpy(),
        tree["blocks"]["mamba"]["wx"][2].astype(np.float32))
    model = MambaLM(cfg, device="cpu")
    model.load_state_dict(sd)
    assert model.blocks[0].mamba["D"].dtype == torch.float32


@pytest.mark.parametrize("arch,cls,params", [
    ("mamba2-2.7b", MambaLM, 2_701_725_696),
    ("zamba2-7b", Zamba2LM, 6_749_630_976)])
def test_build_model_and_full_width_counts(arch, cls, params):
    """``build_model`` dispatches on the family; the full-width configs
    have the reference's analytic parameter counts, and the reduced model
    holds exactly that count plus its norm scales, conv biases and
    per-head scalars. zamba2's count includes an untied head that the
    model does not have (both heads use ``embed.T``, as the reference's
    do), so zamba2-7b holds 6.64 B parameters, not 6.75 B."""
    cfg = get(arch)
    assert param_count(cfg) == params
    small = get(arch).reduced()
    model = build_model(small, device="cpu")
    assert type(model) is cls
    n = sum(t.numel() for t in model.parameters())
    d, din, h = small.d_model, small.d_inner, small.ssm_heads
    extra = small.n_layers * (d + din + din + 2 * small.ssm_state + 3 * h) \
        + d
    if arch == "zamba2-7b":
        extra += 2 * d - small.vocab * d      # ln1, ln2; no unembed
    assert n == param_count(small) + extra


def test_zamba2_layout():
    """81 mamba blocks as 13 groups of 6 and a tail of 3; the shared
    attention's head_dim is 112."""
    cfg = get("zamba2-7b")
    assert divmod(cfg.n_layers, cfg.hybrid_attn_every) == (13, 3)
    assert cfg.head_dim == 112
    small = Zamba2LM(get("zamba2-7b").reduced(), device="cpu")
    assert (small.n_groups, small.n_tail) == (2, 1)
    assert len(small.groups) == 2 and len(small.tail) == 1
