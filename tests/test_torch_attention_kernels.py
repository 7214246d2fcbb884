"""The attention kernels' plain versions (B3 flash prefill, B4 flash
decode), through the port's layout wrappers on CPU tensors, against the
reference's Pallas kernels (interpret mode, as ``tests/test_kernels.py``
runs them) and its ``ref`` oracles, over the reference's own sweeps and
zamba2's head_dim of 112.

Inputs are drawn with numpy and handed to both packages; bfloat16 inputs
round the same float32 values in both. Tolerances are the reference's
kernel tests': 2e-5 in float32 (sums in another order), 2e-2 in bfloat16
(both sides round their float32 result to bfloat16).

Two test-only emulations follow the CUDA kernels' own numerics, which the
CPU cannot run: the tensor-core bfloat16 B3 (fp32 scores of bf16 inputs,
the scale folded into exp2, P·V over the bf16 hi and lo parts of each
weight, over the kernel's kv tiles) against the reference's Pallas
kernel, and B4's split-and-combine (partial softmax states per block of
``decode_split``, merged as the cluster merges them) against
``decode_attention_plain``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.flash_attention import \
    flash_attention_folded as ref_flash_folded
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


class _Elsewhere(torch.Tensor):
    """A tensor's metadata on a device the kernels have no route for."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def test_flash_attention_refuses_bad_operands():
    q = torch.zeros(1, 8, 1, 1, 16)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :4], k[:, :4])
    with pytest.raises(ValueError):        # meta runs the kernel's checks
        ops.flash_attention(q.to("meta"), k[:, :4].to("meta"),
                            k[:, :4].to("meta"))
    out = ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError):        # no route off the CPU, card, meta
        fa.flash_attention_folded(_Elsewhere((1, 1, 1, 8, 16)),
                                  _Elsewhere((1, 1, 8, 16)),
                                  _Elsewhere((1, 1, 8, 16)), causal=True,
                                  window=0)


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


def test_flash_route_and_tiles_follow_head_dim_and_dtype():
    """B3's route, chosen on the host: wgmma for bf16 at the served
    head_dims, mma.sync at 16 and 256, the CUDA cores in float32; each
    bf16 route's tiles as the kernel sets them (held to the built library
    by ``chip_smoke.py`` and ``test_torch_cuda.py``)."""
    for hd in fa.HEAD_DIMS:
        assert fa.route(hd, torch.float32) == "f32"
        assert fa.route(hd, torch.bfloat16) == (
            "wgmma" if hd in (64, 112, 128) else "mma")
        with pytest.raises(ValueError, match="float32"):
            fa.tile_geometry(hd, torch.float32)
    assert all(fa.tile_geometry(hd, torch.bfloat16) == {"bq": 128, "bkv": 128}
               for hd in (64, 112, 128))
    assert fa.tile_geometry(16, torch.bfloat16) == {"bq": 128, "bkv": 64}
    assert fa.tile_geometry(256, torch.bfloat16) == {"bq": 128, "bkv": 32}
    assert set(fa.ROUTES) == {"f32", "mma", "wgmma"}
    with pytest.raises(ValueError, match="head_dim"):
        fa.route(32, torch.bfloat16)
    with pytest.raises(TypeError):
        fa.route(64, torch.float16)


def test_flash_issued_flops_count_whole_tiles_and_the_lo_products():
    """The wgmma route's issued work: 1.5x the band's FLOPs (P.V twice)
    where the band fills whole 128 x 128 tiles, more where tiles cross the
    diagonal, the window's edge or the ragged tail."""
    def args(b, s, kh, g, hd):
        return (torch.empty((b, kh, g, s, hd), dtype=torch.bfloat16,
                            device="meta"),
                torch.empty((b, kh, s, hd), dtype=torch.bfloat16,
                            device="meta"),
                torch.empty((b, kh, s, hd), dtype=torch.bfloat16,
                            device="meta"))
    full = args(2, 256, 2, 2, 128)
    band = fa.cost(*full, causal=False, window=0)["flops"]
    assert fa.issued_flops(*full, causal=False, window=0) == 3 * band // 2
    # qwen3-0.6b's prefill: 136 of the 16 x 16 tiles, 16 on the diagonal
    qwen = args(8, 2048, 8, 2, 128)
    assert fa.issued_flops(*qwen, causal=True, window=0) == \
        8 * 8 * 2 * 136 * 128 * 128 * 6 * 128
    assert fa.issued_flops(*qwen, causal=True, window=0) > \
        3 * fa.cost(*qwen, causal=True, window=0)["flops"] // 2
    # a window of 7: the second and third q tiles reach back into the kv
    # tile before their own
    w7 = args(1, 300, 1, 1, 128)
    assert fa.issued_flops(*w7, causal=True, window=7) == \
        (1 + 2 + 2) * 128 * 128 * 6 * 128
    with pytest.raises(ValueError, match="wgmma"):
        fa.issued_flops(*args(1, 64, 1, 1, 256), causal=True, window=0)


def _b3_tensor_core_emulation(q, k, v, *, causal, window):
    """What the bfloat16 B3 kernel computes, in float32 torch ops on the
    CPU: q (BK, G, S, hd), k, v (BK, S, hd) bf16 -> bf16. Scores are fp32
    sums of exact bf16 products; the scale, folded with log2(e), enters at
    exp2 as in the kernel; each kv tile's weights enter P·V as two bf16
    parts, hi = bf16(p) and lo = bf16(p - hi), and l sums the fp32 weights;
    o = acc / max(l, 1e-30). Every kv tile is visited: a tile outside a
    row's band adds exactly nothing (a wholly masked first tile's weights
    are wiped by corr = 0), which is why the kernel may skip it."""
    bk, g, s, hd = q.shape
    bkv = fa.tile_geometry(hd, torch.bfloat16)["bkv"]   # the kernel's kv tile
    sl2 = torch.tensor(np.float32(hd ** -0.5) * np.float32(1.4426950408889634))
    qf, kf, vf = q.float(), k.float(), v.float()
    qpos = torch.arange(s)[:, None]
    m = torch.full((bk, g, s), fa.NEG_INF)
    l = torch.zeros((bk, g, s))
    acc = torch.zeros((bk, g, s, hd))
    for k0 in range(0, s, bkv):
        kt, vt = kf[:, k0:k0 + bkv], vf[:, k0:k0 + bkv]
        sc = torch.einsum("bgqd,bcd->bgqc", qf, kt)
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        ok = torch.ones((s, kt.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        sc = torch.where(ok, sc, fa.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2((m - m_new) * sl2)
        p = torch.exp2(sc * sl2 - (m_new * sl2)[..., None])
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + (torch.einsum("bgqc,bcd->bgqd", hi, vt)
                                       + torch.einsum("bgqc,bcd->bgqd", lo,
                                                      vt))
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,kh,g,hd", [
    (1, 64, 1, 1, 64),       # the reference's sweep
    (2, 128, 2, 2, 64),
    (1, 300, 1, 4, 64),      # wgmma: a ragged third 128-row kv tile
    (2, 257, 2, 1, 128),
    (1, 512, 4, 2, 64),
    (2, 200, 2, 1, 112),     # zamba2's head_dim: 7 k-steps, 14 n-tiles
    (1, 100, 2, 3, 256),     # mma.sync: 32-row kv tiles, 16-row warps
])
@pytest.mark.parametrize("window,causal", [
    (0, True), (64, True), (0, False), (64, False)],
    ids=["0", "64", "0-bidirectional", "64-bidirectional"])
def test_tensor_core_flash_numerics_match_reference(b, s, kh, g, hd, window,
                                                    causal):
    """The bf16 B3's rounding points stay within the bf16 tolerance of the
    reference's Pallas kernel (interpret mode) on the same inputs, causal
    and bidirectional (the whisper encoder's prefill)."""
    rng = np.random.default_rng(7 * b + s + hd + window + int(not causal))
    x = [rng.standard_normal(sh).astype(np.float32) for sh in
         ((b * kh, g, s, hd), (b * kh, s, hd), (b * kh, s, hd))]
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in x)
    got = _b3_tensor_core_emulation(q, k, v, causal=causal, window=window)
    want = np.asarray(ref_flash_folded(
        *(jnp.asarray(t, jnp.bfloat16) for t in x), causal=causal,
        window=window, interpret=True), np.float32)
    tol = DTYPES["bfloat16"][2]
    err = np.abs(got.float().numpy() - want)
    margin = float((err / (tol + tol * np.abs(want))).max())
    print(f"B3 bf16 emulation {(b, s, kh, g, hd)} causal {causal} window "
          f"{window}: max_abs_err {err.max():.3g}, worst error / (tol + tol "
          f"|ref|) {margin:.3f}")
    assert np.isfinite(got.float().numpy()).all() and margin <= 1.0


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


def _b4_split_emulation(q, k, v, valid, splits, chunk, tile):
    """B4's split-and-combine in float32: block r of ``splits`` walks slots
    [r * chunk, min((r + 1) * chunk, valid)) in ``tile``-slot tiles with an
    online softmax (q scaled first, as the kernel stages it); the blocks'
    (m, l, acc) merge with weights exp(m_r - max m), an empty block holding
    (NEG_INF, 0, 0). q (BK, G, hd), k, v (BK, C, hd)."""
    hd = q.shape[-1]
    qs = q * np.float32(hd ** -0.5)
    parts = []
    for r in range(splits):
        c0 = min(r * chunk, valid)
        c1 = min(c0 + chunk, valid)
        m = torch.full(q.shape[:2], fa.NEG_INF)
        l = torch.zeros(q.shape[:2])
        acc = torch.zeros(q.shape)
        for base in range(c0, c1, tile):
            kt, vt = k[:, base:min(base + tile, c1)], v[:, base:min(base + tile,
                                                                    c1)]
            sc = torch.einsum("bgd,bcd->bgc", qs, kt)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bgc,bcd->bgd", p, vt)
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    f = [torch.exp(m - mx) for m, _, _ in parts]
    num = sum(fi[..., None] * acc for fi, (_, _, acc) in zip(f, parts))
    den = sum(fi * l for fi, (_, l, _) in zip(f, parts))
    return num / den.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("bk,c,g,hd,valid,splits,tile", [
    (2, 2080, 2, 128, 2048, None, 32),   # qwen3's rows at the serving length
    (2, 2080, 1, 112, 2048, None, 32),   # zamba2's head_dim
    (1, 600, 1, 128, 520, None, 32),     # 8 blocks, the last ones empty
    (2, 100, 3, 64, 1, 8, 64),           # valid 1 over 8 blocks: 7 empty
    (1, 300, 2, 16, 77, 3, 64),
    (1, 64, 4, 256, 64, None, 16),
])
def test_decode_split_and_combine_equals_plain(bk, c, g, hd, valid, splits,
                                               tile):
    """B4's partial states per block, merged as the cluster merges them,
    equal the plain version in float32, empty blocks included (``tile``:
    the kernel's float32 slot tile at that head_dim)."""
    rng = np.random.default_rng(bk + c + valid)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((bk, g, hd), (bk, c, hd), (bk, c, hd)))
    n, chunk = da.decode_split(bk, valid, splits)
    got = _b4_split_emulation(q, k, v, valid, n, chunk, tile)
    want = da.decode_attention_plain(q, k, v, valid)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows,valid", [
    (64, 2048),                      # qwen3-0.6b serving
    (256, 2048),                     # zamba2-7b serving
    (64, 2080),                      # a full cache
    (1, 520),
    *[(r, v) for r in (1, 8, 64) for v in (1, 2, 7, 63, 64, 65, 300, 511,
                                           513)],
])
def test_decode_split_covers_every_live_slot_once(rows, valid):
    """Every live slot lands in exactly one block, every block starts on a
    granule (so on a kernel tile), at most 8 blocks per row (one cluster),
    and block 0 is never empty."""
    splits, chunk = da.decode_split(rows, valid)
    assert 1 <= splits <= da.MAX_SPLIT and chunk % da.GRANULE == 0
    seen = np.zeros(valid, int)
    for r in range(splits):
        c0 = min(r * chunk, valid)
        seen[c0:min(c0 + chunk, valid)] += 1
    assert (seen == 1).all() and min(chunk, valid) >= 1


def test_decode_split_takes_a_forced_count_and_refuses_a_bad_one():
    assert da.decode_split(64, 2048, 8) == (8, 256)
    assert da.decode_split(1, 1, 8) == (8, 64)    # 7 empty blocks
    for bad in (0, 9):
        with pytest.raises(ValueError):
            da.decode_split(64, 2048, bad)


def test_decode_split_at_the_serving_shapes():
    """qwen3-0.6b's 64 rows take 3 blocks of 11 granules; zamba2-7b's 256
    rows one block each (2048 live slots)."""
    assert da.decode_split(64, 2048) == (3, 704)
    assert da.decode_split(256, 2048) == (1, 2048)
