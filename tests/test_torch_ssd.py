"""The SSD intra-chunk form (kernel B5): its plain version, through the
port's layout wrapper on CPU tensors, against the reference's Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) and its
``ref.ssd_intra_ref`` oracle, over the reference's own sweep; causality, the
masked entries above the diagonal, and the wrapper's refusals.

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
    with pytest.raises(ValueError):        # no route off the CPU and card
        ssd_scan.ssd_intra_folded(*(a.to("meta") for a in fold))


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
