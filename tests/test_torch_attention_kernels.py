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
kernel, and B4's split and merge (``work_split``'s tile ranges, an
online softmax per consumer warp over its slots of each tile, the warps'
and then the blocks' partial states merged as the kernel merges them)
against ``decode_attention_plain``.
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
    head_dims (64, 112, 128 and gemma-7b's 256), mma.sync at 16, the CUDA
    cores in float32; each bf16 route's tiles as the kernel sets them (held
    to the built library by ``chip_smoke.py`` and ``test_torch_cuda.py``):
    80-row kv tiles at 256, where O takes 128 registers a thread."""
    for hd in fa.HEAD_DIMS:
        assert fa.route(hd, torch.float32) == "f32"
        assert fa.route(hd, torch.bfloat16) == (
            "wgmma" if hd in (64, 112, 128, 256) else "mma")
        with pytest.raises(ValueError, match="float32"):
            fa.tile_geometry(hd, torch.float32)
    assert all(fa.tile_geometry(hd, torch.bfloat16) == {"bq": 128, "bkv": 128}
               for hd in (64, 112, 128))
    assert fa.tile_geometry(16, torch.bfloat16) == {"bq": 128, "bkv": 64}
    assert fa.tile_geometry(256, torch.bfloat16) == {"bq": 128, "bkv": 80}
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
    # gemma-7b's prefill at head_dim 256, 80-row kv tiles: q tile t meets
    # ceil(128 (t + 1) / 80) of them, 224 in all
    gemma = args(8, 2048, 16, 1, 256)
    assert sum(-(-128 * (t + 1) // 80) for t in range(16)) == 224
    assert fa.issued_flops(*gemma, causal=True, window=0) == \
        8 * 16 * 224 * 128 * 80 * 6 * 256
    with pytest.raises(ValueError, match="wgmma"):
        fa.issued_flops(*args(1, 64, 1, 1, 16), causal=True, window=0)


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
    (1, 100, 2, 3, 256),     # wgmma at gemma-7b's head_dim: 80-row kv
    (2, 300, 1, 2, 256),     # tiles, G 3, a ragged second one; 3 q tiles
    (2, 200, 2, 2, 16),      # mma.sync: 64-row kv tiles, 16-row warps
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


def _b4_merge(parts):
    """(m, l, acc) states merged with weights exp2(m_r - max m), as the
    kernel merges its warps' and its blocks' shares (log2 units)."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    f = [torch.exp2(m - mx) for m, _, _ in parts]
    acc = sum(fi[..., None] * a for fi, (_, _, a) in zip(f, parts))
    return mx, sum(fi * l for fi, (_, l, _) in zip(f, parts)), acc


def _b4_emulation(q, k, v, valid, blocks, dtype):
    """B4's split and merge in float32 (q (BK, G, hd), k, v (BK, C, hd)) at
    the kernel's geometry for ``dtype``: the (row, head group) rows' tiles
    cut by ``work_split`` into ``blocks`` ranges; in a block each consumer
    warp runs an online softmax over its slots of each tile of a row
    segment (scores in log2 units, one max per tile, dead slots weigh 0),
    the warps merge at the segment's end, a whole row is written out and a
    row's shares over blocks merge last. Returns the output and the number
    of rows that were split over blocks."""
    bk_n, G, hd = q.shape
    ts, spw = da.geometry(hd, dtype)
    gc = da.group_size(G)
    ng, tiles = -(-G // gc), -(-valid // ts)
    qs = q * np.float32(hd ** -0.5 * np.log2(np.e))
    owner = (torch.arange(ts) // spw) % da.CONSUMER_WARPS
    out = torch.zeros_like(q)
    shares = {}
    for x0, x1 in da.work_split(bk_n * ng, tiles, blocks):
        for row in range(x0 // tiles, (x1 - 1) // tiles + 1):
            t0 = max(x0, row * tiles) - row * tiles
            t1 = min(x1, (row + 1) * tiles) - row * tiles
            bk, hg = divmod(row, ng)
            heads = slice(hg * gc, min(G, (hg + 1) * gc))
            qh = qs[bk, heads]
            warps = []
            for w in range(da.CONSUMER_WARPS):
                m = torch.full((qh.shape[0],), fa.NEG_INF)
                l = torch.zeros(qh.shape[0])
                acc = torch.zeros(qh.shape)
                for t in range(t0, t1):
                    slots = t * ts + torch.nonzero(owner == w)[:, 0]
                    live = slots < valid
                    idx = slots.clamp(max=valid - 1)
                    sc = torch.where(live, qh @ k[bk, idx].T, fa.NEG_INF)
                    mn = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp2(m - mn)
                    pw = torch.where(live, torch.exp2(sc - mn[:, None]), 0.)
                    l = l * corr + pw.sum(-1)
                    acc = acc * corr[:, None] + pw @ v[bk, idx]
                    m = mn
                warps.append((m, l, acc))
            state = _b4_merge(warps)
            if t0 == 0 and t1 == tiles:
                out[bk, heads] = state[2] / state[1].clamp_min(1e-30)[:, None]
            else:
                shares.setdefault(row, []).append(state)
    for row, parts in shares.items():
        bk, hg = divmod(row, ng)
        _, l, acc = _b4_merge(parts)
        out[bk, hg * gc:min(G, (hg + 1) * gc)] = \
            acc / l.clamp_min(1e-30)[:, None]
    return out, len(shares)


@pytest.mark.parametrize("bk,c,g,hd,valid,blocks,dtype,split", [
    # qwen3's rows at the serving length, 264 blocks: 15-16 tiles each,
    # ranges crossing rows
    (64, 2080, 2, 128, 2048, 264, "bfloat16", True),
    (8, 2080, 1, 112, 2048, 264, "bfloat16", True),   # zamba2's head_dim
    (1, 600, 1, 128, 520, 50, "float32", True),       # one row, 33 blocks
    (3, 300, 2, 64, 200, 5, "float32", True),         # a range across rows
    (2, 100, 3, 64, 1, 8, "bfloat16", False),   # valid 1: 3 warps empty
    (2, 300, 8, 16, 7, 4, "bfloat16", False),   # valid inside the first tile
    (2, 300, 12, 16, 257, 7, "float32", True),  # G 12: two head groups
    (1, 64, 4, 256, 64, 3, "float32", True),    # hd 256: 8-slot tiles
    (4, 1000, 2, 128, 999, 1, "bfloat16", False),   # one block, every row
    (1, 8200, 2, 128, 8200, 264, "bfloat16", True),  # a batch-1 rank slice
])
def test_decode_split_and_merge_equals_plain(bk, c, g, hd, valid, blocks,
                                             dtype, split):
    """B4's per-warp online softmax, the warps' merge and the blocks'
    merge, over ``work_split``'s ranges at the kernel's tiles for
    ``dtype``, equal the plain version in float32 (rtol = atol = 1e-6),
    with empty warp shares, ranges that cross rows and rows shared by
    several blocks (``split``)."""
    rng = np.random.default_rng(bk + c + valid + blocks)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((bk, g, hd), (bk, c, hd), (bk, c, hd)))
    got, n_split = _b4_emulation(q, k, v, valid, blocks,
                                 DTYPES[dtype][1])
    assert (n_split > 0) == split
    want = da.decode_attention_plain(q, k, v, valid)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hd", [16, 64, 112, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_geometry_at_every_head_dim(hd, dtype):
    """bfloat16 (tensor cores): tiles of 16 slots a consumer warp, one k16
    step of P.V each. float32 (CUDA cores): a tile is a power of two of
    slots near 8 KB of K (at most 256, TMA's box), every warp owns the same
    number of slot steps of it, and a step's rows are read by a power of
    two of lanes that covers a row's 16-byte chunks: a warp step reads one
    contiguous run of shared memory."""
    tdt = DTYPES[dtype][1]
    ts, spw = da.geometry(hd, tdt)
    if dtype == "bfloat16":
        assert (ts, spw) == (16 * da.CONSUMER_WARPS, 16)
        return
    row = 4 * hd
    lanes = 32 // spw
    assert lanes * spw == 32 and lanes >= min(32, row // 16) > lanes // 2
    assert ts <= 256 and ts * row <= da.TILE_BYTES < 2 * ts * row or ts == 256
    assert ts % (da.CONSUMER_WARPS * spw) == 0


def test_decode_group_size_and_refusals():
    assert [da.group_size(g) for g in (1, 2, 3, 4, 5, 7, 8, 12)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]
    with pytest.raises(ValueError):
        da.work_split(64, 64, 0)
    with pytest.raises(ValueError):
        da.geometry(32, torch.bfloat16)
    with pytest.raises(TypeError):
        da.geometry(128, torch.float16)


@pytest.mark.parametrize("rows,valid,hd,dtype,blocks", [
    (64, 2048, 128, "bfloat16", 264),      # qwen3-0.6b serving
    (256, 2048, 112, "bfloat16", 264),     # zamba2-7b serving
    (128, 1024, 128, "bfloat16", 264),     # gemma3-27b's rings
    (8, 8200, 128, "bfloat16", 264),       # qwen3's 1 x 8,200 rank slice
    (64, 2080, 128, "float32", 132),       # a full cache
    (1, 520, 128, "float32", 50),
    *[(r, v, 128, "bfloat16", n) for r in (1, 8, 64)
      for v in (1, 2, 31, 32, 33, 300, 513) for n in (1, 7, 264)
      if (r * v) % 3 == 0 or n == 264],
    (2, 100, 16, "bfloat16", 3),           # 256-slot tiles: one a row
    (3, 77, 256, "float32", 10),           # 8-slot tiles
])
def test_decode_work_split_covers_every_live_slot_once(rows, valid, hd,
                                                       dtype, blocks):
    """Every live (row, slot) lands in exactly one block's range, every
    block has a tile or more, no block holds two tiles more than another
    (so the bytes it waits for, whole tiles, differ by one tile at most),
    and the grid is ``blocks`` unless there are fewer tiles."""
    ts, _ = da.geometry(hd, DTYPES[dtype][1])
    tiles = -(-valid // ts)
    ranges = da.work_split(rows, tiles, blocks)
    assert len(ranges) == min(blocks, rows * tiles)
    seen = np.zeros((rows, valid), int)
    for x0, x1 in ranges:
        assert x1 > x0
        for x in range(x0, x1):
            r, t = divmod(x, tiles)
            seen[r, t * ts:min((t + 1) * ts, valid)] += 1
    assert (seen == 1).all()
    counts = [x1 - x0 for x0, x1 in ranges]
    assert max(counts) - min(counts) <= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == rows * tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("rows,valid,hd,grid,want", [
    (64, 2048, 128, 264, (7, 8)),    # qwen3-0.6b: 8 x 8 kv heads, 32 a row
    (256, 2048, 112, 256, (32,)),    # zamba2-7b: 8 x 32, a whole row a block
    (128, 1024, 128, 264, (7, 8)),   # gemma3-27b's rings: 8 x 16, 16 a row
    (8, 8200, 128, 264, (3, 4)),     # a 1 x 8,200 rank slice: 129 a row
])
def test_decode_work_split_at_the_serving_shapes(rows, valid, hd, grid,
                                                 want):
    """At 132 SMs and two blocks an SM, bf16: the default grid fills all
    264 slots, the batch-1 slice's 8 rows included, with ``want`` tiles a
    block; zamba2-7b's 256 rows take 256 blocks of one whole row each (no
    row shared, no merge)."""
    ts, _ = da.geometry(hd, torch.bfloat16)
    tiles = -(-valid // ts)
    assert da.default_grid(rows, tiles, 2 * 132) == grid
    ranges = da.work_split(rows, tiles, grid)
    assert len(ranges) == grid
    assert sorted({x1 - x0 for x0, x1 in ranges}) == list(want)


@pytest.mark.parametrize("rows,tiles,slots,grid", [
    (512, 32, 264, 256),    # two whole rows a block
    (250, 10, 264, 264),    # whole rows would leave 14 of 264 slots empty
    (530, 4, 264, 264),     # 265 a block pair is one too many
    (7, 3, 264, 21),        # fewer tiles than slots: a block a tile
    (1, 1, 264, 1),
])
def test_decode_default_grid_takes_whole_rows_only_when_they_fill_the_card(
        rows, tiles, slots, grid):
    assert da.default_grid(rows, tiles, slots) == grid
