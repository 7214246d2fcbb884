"""The attention kernels' plain versions (B3 flash prefill, B4 flash
decode), through the port's layout wrappers on CPU tensors, against the
reference's Pallas kernels (interpret mode, as ``tests/test_kernels.py``
runs them) and its ``ref`` oracles, over the reference's own sweeps and
zamba2's head_dim of 112.

Inputs are drawn with numpy and handed to both packages; bfloat16 inputs
round the same float32 values in both. Tolerances are the reference's
kernel tests': 2e-5 in float32 (sums in another order), 2e-2 in bfloat16
(both sides round their float32 result to bfloat16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# B3: flash prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,kh,g,hd", [
    (1, 64, 1, 1, 64),       # minimal
    (2, 128, 2, 2, 64),      # GQA
    (1, 300, 1, 4, 64),      # non-multiple seq (padding path)
    (2, 257, 2, 1, 128),     # odd seq, wide head
    (1, 512, 4, 2, 64),      # multi-tile
    (2, 200, 2, 1, 112),     # zamba2's head_dim, not a power of two
])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(b, s, kh, g, hd, window, dtype):
    rng = np.random.default_rng(b * 1000 + s + window)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, sh, dtype) for sh in (
        (b, s, kh, g, hd), (b, s, kh, hd), (b, s, kh, hd)))
    tol = DTYPES[dtype][2]
    before = fa.flash_attention_folded.launches
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert fa.flash_attention_folded.launches == before   # CPU: plain
    assert got.shape == (b, s, kh, g, hd) and got.dtype == qt.dtype
    _close(got, ref_ops.flash_attention(qj, kj, vj, causal=True,
                                        window=window), tol, "pallas")
    _close(got, ref.flash_attention_ref(qj, kj, vj, causal=True,
                                        window=window), tol, "ref")


def test_flash_attention_first_row_attends_to_itself():
    """Causal row 0 sees only key 0: its output is v[0]."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 8, 1, 1, 64), (1, 8, 1, 64), (1, 8, 1, 64)))
    out = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out[0, 0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_flash_folded_and_split_layouts_agree(causal, window):
    """The folded (BK, G, S, hd) form equals the row-split (B, K, G, S, hd)
    form and the model-layout wrapper, bit for bit."""
    rng = np.random.default_rng(9)
    b, s, kh, g, hd = 2, 37, 3, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, s, kh, g, hd)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kh, hd)).astype(
        np.float32)) for _ in range(2))
    qs, ks, vs = (q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3),
                  v.permute(0, 2, 1, 3))
    split = fa.flash_attention_folded(qs, ks, vs, causal=causal,
                                      window=window)
    folded = fa.flash_attention_folded(
        qs.reshape(b * kh, g, s, hd), ks.reshape(b * kh, s, hd),
        vs.reshape(b * kh, s, hd), causal=causal, window=window)
    model = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(folded.reshape(b, kh, g, s, hd), split)
    assert torch.equal(model, split.permute(0, 3, 1, 2, 4))


def test_flash_attention_refuses_bad_operands():
    q = torch.zeros(1, 8, 1, 1, 16)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :4], k[:, :4])
    with pytest.raises(ValueError):        # no route off the CPU and card
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def test_operand_check_takes_the_model_layout_views():
    """The kernels' operand check (device-agnostic) accepts the permuted
    views the wrappers pass and refuses misaligned or strided rows."""
    q = torch.zeros(1, 300, 2, 4, 64)
    fa.check_operand("q", q.permute(0, 2, 3, 1, 4), q)
    fa.check_operand("k", q[:, :, :, 0].permute(0, 2, 1, 3), q)
    with pytest.raises(ValueError, match="aligned"):
        fa.check_operand("q", q.flatten()[1:].view(q.shape[0], -1)[:, :64]
                         .reshape(1, 1, 1, 1, 64), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_operand("q", q.transpose(-1, -2), q)
    with pytest.raises(TypeError):
        fa.check_operand("q", q.half(), q)


# ---------------------------------------------------------------------------
# B4: flash decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,c,kh,g,hd,valid", [
    (1, 64, 1, 1, 64, 64),
    (2, 256, 2, 4, 64, 100),
    (1, 2048, 4, 1, 128, 2048),
    (2, 100, 1, 8, 64, 1),          # single valid slot
    (1, 1000, 2, 2, 64, 999),       # ragged cache
    (2, 300, 2, 1, 112, 257),       # zamba2's head_dim: 28 lanes of 4
    (1, 64, 1, 3, 112, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(b, c, kh, g, hd, valid, dtype):
    rng = np.random.default_rng(b * 1000 + c + valid)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, sh, dtype) for sh in (
        (b, kh, g, hd), (b, c, kh, hd), (b, c, kh, hd)))
    tol = DTYPES[dtype][2]
    vl = jnp.asarray(valid, jnp.int32)
    before = da.decode_attention_folded.launches
    got = ops.decode_attention(qt, kt, vt, valid)
    assert da.decode_attention_folded.launches == before   # CPU: plain
    assert got.shape == (b, kh, g, hd) and got.dtype == qt.dtype
    _close(got, ref_ops.decode_attention(qj, kj, vj, vl), tol, "pallas")
    _close(got, ref.decode_attention_ref(qj, kj, vj, vl), tol, "ref")


def test_decode_attention_ignores_dead_slots():
    """Garbage (+-1e9) beyond valid_len does not move the output."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 64)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 128, 1, 64)).astype(
        np.float32)) for _ in range(2))
    out1 = ops.decode_attention(q, k, v, 50)
    k2, v2 = k.clone(), v.clone()
    k2[:, 50:] = 1e9
    v2[:, 50:] = -1e9
    out2 = ops.decode_attention(q, k2, v2, 50)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


def test_decode_folded_and_split_layouts_agree():
    rng = np.random.default_rng(6)
    b, c, kh, g, hd = 2, 40, 3, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, kh, g, hd)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, c, kh, hd)).astype(
        np.float32)) for _ in range(2))
    model = ops.decode_attention(q, k, v, 33)
    folded = da.decode_attention_folded(
        q.reshape(b * kh, g, hd),
        k.permute(0, 2, 1, 3).reshape(b * kh, c, hd),
        v.permute(0, 2, 1, 3).reshape(b * kh, c, hd), 33)
    assert torch.equal(folded.reshape(b, kh, g, hd), model)
    # a 0-d tensor valid_len is the same as the int
    assert torch.equal(ops.decode_attention(q, k, v, torch.tensor(33)),
                       model)


@pytest.mark.parametrize("valid", [0, 41])
def test_decode_attention_refuses_bad_valid_len(valid):
    q = torch.zeros(1, 1, 1, 16)
    k = torch.zeros(1, 40, 1, 16)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, k, valid)
