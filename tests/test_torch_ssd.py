"""The SSD intra-chunk form (kernel B5): its plain version, through the
port's layout wrapper on CPU tensors, against the reference's Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) and its
``ref.ssd_intra_ref`` oracle, over the reference's own sweep; causality, the
masked entries above the diagonal, and the wrapper's refusals; an
emulation of the CUDA kernel's 3xTF32 tensor-core rounding (the CPU cannot
run the kernel) against the Pallas kernel; and the host's side of the
kernel's two routes: the route by shape, the wgmma route's work list and
its issued tensor work in ``cost``.

Inputs are drawn with numpy as the reference test draws them and handed to
both packages. Tolerance 1e-4 (rtol and atol), float32: the reference
test's, for sums taken in another order.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import ops, ssd_scan

TOL = 1e-4


def _inputs(b, c, q, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, c, q, h, p)).astype(np.float32)
    la = -np.abs(rng.standard_normal((b, c, q, h))).astype(np.float32) * 0.1
    cum = np.cumsum(la, axis=2)
    B = rng.standard_normal((b, c, q, n)).astype(np.float32)
    C = rng.standard_normal((b, c, q, n)).astype(np.float32)
    return xc, cum, B, C


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,c,q,h,p,n", [
    (1, 1, 16, 1, 8, 4),
    (1, 2, 64, 2, 32, 16),
    (2, 3, 37, 1, 16, 8),        # ragged q
    (1, 1, 128, 4, 64, 128),     # production-ish tile
])
def test_ssd_intra_matches_reference(b, c, q, h, p, n):
    """``ops.ssd_intra`` and ``ssd_intra_plain`` on the folded layout
    against the reference's Pallas kernel and oracle."""
    arrays = _inputs(b, c, q, h, p, n, b * 100 + q)
    before = ssd_scan.ssd_intra_folded.launches
    got = ops.ssd_intra(*_t(*arrays))
    assert ssd_scan.ssd_intra_folded.launches == before      # CPU: plain
    assert got.shape == (b, c, q, h, p) and got.dtype == torch.float32
    for tag, want in (("pallas", ref_ops.ssd_intra(*arrays)),
                      ("ref", ref.ssd_intra_ref(*arrays))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=tag)
    folded = [a.reshape(b * c, *a.shape[2:]) for a in _t(*arrays)]
    plain = ssd_scan.ssd_intra_plain(*folded)
    assert torch.equal(plain.reshape(got.shape), got)


def test_ssd_intra_is_causal():
    """Changing future inputs must not change past outputs."""
    xc, cum, B, C = _inputs(1, 1, 32, 1, 8, 4, 7)
    out1 = ops.ssd_intra(*_t(xc, cum, B, C))
    xc2 = xc.copy()
    xc2[:, :, 20:] += 5.0
    B2 = B.copy()
    B2[:, :, 20:] -= 3.0
    out2 = ops.ssd_intra(*_t(xc2, cum, B2, C))
    np.testing.assert_allclose(out1[:, :, :20].numpy(),
                               out2[:, :, :20].numpy(), atol=1e-5)
    assert not torch.allclose(out1[:, :, 20:], out2[:, :, 20:])


def test_ssd_intra_large_decay_gap_above_the_diagonal():
    """A steep cumulative log-decay makes cum_i - cum_j reach +500 above
    the diagonal, where exp overflows to inf: those entries are selected
    away, never multiplied by a zero mask, so nothing is NaN."""
    xc, _, B, C = _inputs(1, 1, 64, 2, 8, 4, 3)
    cum = np.broadcast_to(np.linspace(0.0, -500.0, 64, dtype=np.float32)
                          [None, None, :, None], (1, 1, 64, 2)).copy()
    got = ops.ssd_intra(*_t(xc, cum, B, C))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.ssd_intra_ref(xc, cum, B, C)),
                               atol=TOL, rtol=TOL)


def test_ssd_intra_takes_column_slices():
    """B and C as column slices of one wider tensor (the model's fused
    projection) give the same result as contiguous copies."""
    xc, cum, B, C = _inputs(2, 1, 24, 3, 8, 8, 5)
    wide = np.concatenate([np.zeros((2, 1, 24, 4), np.float32), B, C], -1)
    w = torch.from_numpy(wide)
    got = ops.ssd_intra(*_t(xc, cum), w[..., 4:12], w[..., 12:])
    want = ops.ssd_intra(*_t(xc, cum, B, C))
    assert torch.equal(got, want)


def test_ssd_intra_refuses_bad_operands():
    xc, cum, B, C = _t(*_inputs(1, 1, 16, 2, 8, 4, 0))
    fold = [a.reshape(-1, *a.shape[2:]) for a in (xc, cum, B, C)]
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_intra_folded(fold[0].double(), *fold[1:])
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_intra_folded(*fold[:2], fold[2].bfloat16(), fold[3])
    with pytest.raises(ValueError, match="cum"):
        ssd_scan.ssd_intra_folded(fold[0], fold[1][:, :8], *fold[2:])
    with pytest.raises(ValueError, match="Bc and Cc"):
        ssd_scan.ssd_intra_folded(*fold[:3], fold[3][..., :2])
    meta = [a.to("meta") for a in fold]    # a schedule (measurements')
    with pytest.raises(ValueError, match="heads"):
        ssd_scan._launch(*meta, dict(heads=17))
    with pytest.raises(ValueError, match="window"):
        ssd_scan._launch(*meta, dict(window=0))
    with pytest.raises(ValueError, match="route"):     # P 8: mma only
        ssd_scan._launch(*meta, dict(route="wgmma"))
    with pytest.raises(ValueError, match="schedule"):
        ssd_scan._launch(*meta, dict(walk=1))
    out = ssd_scan.ssd_intra_folded(*(a.to("meta") for a in fold))
    assert out.device.type == "meta" and out.shape == fold[0].shape
    with pytest.raises(ValueError):        # no route off the CPU, card, meta
        ssd_scan.ssd_intra_folded(*(_Elsewhere(a.shape) for a in fold))


class _Elsewhere(torch.Tensor):
    """A tensor's metadata on a device the kernel has no route for."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def test_alignment_check_refuses_what_the_kernel_cannot_load():
    """The kernel's operand check (device-agnostic): contiguous rows of
    16-byte multiples pass; a shifted pointer, a row stride that is not a
    multiple of 4 floats or a strided last axis are refused."""
    x = torch.zeros(4, 16, 3, 8)
    ssd_scan.check_aligned("xc", x)
    ssd_scan.check_aligned("Bc", torch.zeros(4, 16, 20)[..., 4:12])
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan.check_aligned("xc", torch.zeros(1 + x.numel())[1:].view(
            x.shape))
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan.check_aligned("Bc", torch.zeros(4, 16, 18)[..., 2:10])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.check_aligned("Cc", torch.zeros(4, 8, 16).transpose(1, 2))


# ---------------------------------------------------------------------------
# the kernel's 3xTF32 tensor-core route, emulated on the CPU
# ---------------------------------------------------------------------------

def _tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero (13 low bits cleared)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a, route="mma"):
    """A float32 operand as the route's TF32 parts: hi rounded; lo rounded
    too on the mma route, and on the wgmma route passed as it is, which the
    tensor core reads with its low 13 bits dropped (a tensor core that
    rounded them instead would only come closer)."""
    hi = _tf32(a)
    lo = a - hi
    if route == "mma":
        return hi, _tf32(lo)
    return hi, (lo.contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def _mm3(a, b, route="mma"):
    """a @ b as the kernel's three products: the small terms lo·hi + hi·lo
    and the large one hi·hi summed apart, then added; every product of two
    TF32 values is exact in float32, the sums are float32."""
    (ah, al), (bh, bl) = _split(a, route), _split(b, route)
    return (al @ bh + ah @ bl) + ah @ bh


def _b5_tensor_core_emulation(xc, cum, Bc, Cc, route="mma"):
    """What the kernel's ``route`` computes, on the folded layout in
    float32: scores C·Bᵀ in 3xTF32; W = scores · 2^((cum_i − cum_j) ·
    log2 e) in float32 with j > i set to 0 before the exp is taken (the
    kernel's ex2.approx differs from this exact exp2 by ~2^-22 relative);
    W·x in 3xTF32. The ``mma.sync`` route (the earlier kernel) rounds at
    these points; the ``wgmma`` route at the same ones, but for its lo parts
    (``_split``). It
    splits C and W in registers and B and x once an item in shared memory
    (its integer rounding is ``_tf32``'s) and keeps the small products in
    their own accumulator; its k order within each 8 columns (0 2 4 6 1 3
    5 7) only reorders float32 sums."""
    q = xc.shape[1]
    scores = _mm3(Cc, Bc.transpose(1, 2), route)           # (bc, i, j)
    tril = torch.ones((q, q), dtype=torch.bool).tril()[None, :, :, None]
    li, lj = cum[:, :, None, :], cum[:, None, :, :]        # (bc, i/j, h)
    gap = torch.where(tril, li - lj, 0.0) * np.float32(1.4426950408889634)
    w = torch.where(tril, scores[..., None] * torch.exp2(gap), 0.0)
    w = w.permute(0, 3, 1, 2)                              # (bc, h, i, j)
    return _mm3(w, xc.permute(0, 2, 1, 3), route).permute(0, 2, 1, 3)


def test_tf32_rounding_keeps_ten_bits_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0, 0.0])
    got = _tf32(x)
    assert torch.equal(got[:5], want[:5])
    hi, lo = _split(torch.tensor([np.float32(np.pi)]))
    assert abs(float(hi + lo) - np.float32(np.pi)) < 2.0 ** -21


@pytest.mark.parametrize("bc,q,h,p,n,steep", [
    (2, 256, 3, 64, 128, False),     # mamba2-2.7b's chunk, head_dim, state
    (2, 256, 3, 64, 64, False),      # zamba2-7b's state
    (3, 232, 2, 64, 128, False),     # a ragged last chunk (1000 = 3·256 + 232)
    (1, 100, 3, 16, 8, True),        # cum_i − cum_j reaches +500 above
    (2, 256, 4, 64, 128, True),      # the same on the wgmma route
])
def test_tensor_core_ssd_numerics_match_reference(bc, q, h, p, n, steep):
    """The rounding points of the kernel's route at this shape stay within
    1e-4 + 1e-4 |ref| of the reference's Pallas kernel (interpret mode) on
    the same inputs, with nothing inf or NaN where exp overflows above the
    diagonal."""
    route = ssd_scan.route(p, n)
    xc, cum, B, C = (a[:, 0] for a in _inputs(bc, 1, q, h, p, n, q + n))
    if steep:
        cum = np.broadcast_to(np.linspace(0.0, -500.0, q, dtype=np.float32)
                              [None, :, None], (bc, q, h)).copy()
    got = _b5_tensor_core_emulation(*_t(xc, cum, B, C), route=route).numpy()
    want = np.asarray(ref_ops.ssd_intra(
        *(a[:, None] for a in (xc, cum, B, C))))[:, 0]
    err = np.abs(got - want)
    margin = float((err / (TOL + TOL * np.abs(want))).max())
    print(f"B5 3xTF32 emulation ({route}) {(bc, q, h, p, n)} steep={steep}: "
          f"max_abs_err {err.max():.3g}, worst error / (tol + tol |ref|) "
          f"{margin:.4f}")
    assert np.isfinite(got).all() and margin <= 1.0
    # one TF32 rounding per operand, no split, would not hold 1e-4 here
    if not steep:
        one = (_tf32(torch.from_numpy(C)) @ _tf32(torch.from_numpy(B))
               .transpose(1, 2)).numpy()
        full = np.einsum("bin,bjn->bij", C.astype(np.float64),
                         B.astype(np.float64))
        assert np.abs(one - full).max() > TOL * (1 + np.abs(full).max())


# ---------------------------------------------------------------------------
# the host's side of the two routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,n,want", [
    (64, 128, "wgmma"),             # mamba2-2.7b
    (64, 64, "wgmma"),              # zamba2-7b
    (64, 32, "mma"), (64, 16, "mma"), (32, 128, "mma"), (128, 64, "mma"),
    (16, 8, "mma"), (8, 4, "mma"),  # the reference sweep's widths
])
def test_route_is_chosen_by_shape(p, n, want):
    """The wgmma route takes P 64 and N 64 or 128; every other width keeps
    the mma.sync route. The choice depends on the shape alone."""
    assert ssd_scan.route(p, n) == want


@pytest.mark.parametrize("bc,q,h,heads,window", [
    (64, 256, 80, None, None),      # mamba2-2.7b's serving call
    (64, 256, 112, None, None),     # zamba2-7b's
    (3, 232, 17, None, 2),          # a ragged chunk, groups of 9 and 8
    (5, 37, 1, None, 4),            # one row tile, one head
    (4, 256, 6, 4, 1),              # groups of 4 and 2, windows of 1
    (7, 200, 3, 2, 64),             # one window over every chunk
])
def test_work_list_takes_each_item_once_heaviest_first(bc, q, h, heads,
                                                      window):
    """Every (chunk, row tile, head group) once; windows of chunks in
    order, each a contiguous run; in each, row tiles from the last (the
    most j tiles) down; groups of at most 16 heads covering every head."""
    items = ssd_scan.work_list(bc, q, h, heads, window)
    per = ssd_scan.head_group(h, heads)
    groups, tiles = -(-h // per), -(-q // 64)
    assert per <= 16 and (groups - 1) * per < h <= groups * per
    assert len(items) == len(set(items)) == bc * tiles * groups
    assert set(items) == {(c, t, g) for c in range(bc) for t in range(tiles)
                          for g in range(groups)}
    window = ssd_scan.WINDOW if window is None else window
    starts = [c // window for c, _, _ in items]
    assert starts == sorted(starts)
    for w in set(starts):
        run = [t for (c, t, _), s in zip(items, starts) if s == w]
        assert run == sorted(run, reverse=True)


@pytest.mark.parametrize("bc,q,h,p,n", [
    (64, 256, 80, 64, 128), (64, 256, 112, 64, 64),
    (3, 232, 17, 64, 128), (2, 100, 6, 64, 64)])
def test_cost_counts_the_wgmma_routes_issued_work(bc, q, h, p, n):
    """``issued_flops``: over the work list, each item's t + 1 j tiles of
    scores (64 x 64 over N) and of each of its heads (64 x 64 over 64),
    three TF32 products each; never less than the band's 3xTF32 work."""
    xc, cum = torch.zeros(bc, q, h, p), torch.zeros(bc, q, h)
    B = torch.zeros(bc, q, n)
    work = ssd_scan.cost(xc, cum, B, B)
    per = ssd_scan.head_group(h)
    want = sum(3 * 2 * 64 * 64 * (t + 1) * (n + min(per, h - g * per) * p)
               for _, t, g in ssd_scan.work_list(bc, q, h))
    assert work["issued_flops"] == want
    assert work["tf32_flops"] <= want
