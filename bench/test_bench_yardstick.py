"""The benchmark's fixed arithmetic and mamba2-2.7b's model FLOPs and B5
launch shapes (its reference's) against values worked by hand at the two
cells' shapes, and B5's frozen cost against the program's own today."""
import json

import pytest
import torch

from bench import harness, yardstick
from bench.reference import mamba2

CONF = json.loads((harness.ROOT / "bench/configs/mamba2-2.7b.json")
                  .read_text())
#: one block's FLOPs a token: projections 2 x 2560 x (2 x 5120 + 2 x 128
#: + 80) and 2 x 5120 x 2560, state update and read-out 4 x 80 x 64 x 128,
#: conv 2 x 4 x (5120 + 256)
BLOCK = 2 * (2560 * 10576 + 5120 * 2560) + 2621440 + 43008
HEAD = 2 * 2560 * 50280


def test_block_and_head_by_hand():
    assert BLOCK == 83_027_968 and HEAD == 257_433_600
    dims = mamba2.dims(CONF)
    assert (dims["heads"], dims["d_inner"]) == (80, 5120)


@pytest.mark.parametrize("batch, prompt, new, prefill, decode", [
    (8, 2048, 32, 87_063_194_042_368, 1_381_663_440_896),
    (128, 128, 64, 87_094_086_074_368, 44_926_346_723_328),
    (256, 128, 64, 174_188_172_148_736, 89_852_693_446_656),
])
def test_mamba2_flops(batch, prompt, new, prefill, decode):
    assert prefill == batch * (prompt * 64 * BLOCK + HEAD)
    assert decode == batch * (new - 1) * (64 * BLOCK + HEAD)
    assert mamba2.flops(CONF, batch, prompt, new) == {
        "prefill": prefill, "decode": decode}


@pytest.mark.parametrize("batch, prompt, shape, flops, nbytes", [
    # 8 rows of 8 chunks of 256: 32,896 pairs a chunk, 2 x 128 + 80 x 131
    # operations a pair; 4 bytes x 64 x 256 x (2 x 80 x 64 + 80 + 256)
    (8, 2048, (64, 256, 80, 64, 128), 22_602_973_184, 693_108_736),
    # 128 rows of one chunk of 128: 8,256 pairs a chunk
    (128, 128, (128, 128, 80, 64, 128), 11_345_461_248, 693_108_736),
    (256, 128, (256, 128, 80, 64, 128), 22_690_922_496, 1_386_217_472),
])
def test_ssd_cost(batch, prompt, shape, flops, nbytes):
    assert mamba2.ssd_launch_shape(CONF, batch, prompt) == shape
    assert yardstick.ssd_cost(*shape) == {"flops": flops, "bytes": nbytes}
    from repro_torch.kernels import ssd_scan
    bc, q, h, p, n = shape
    meta = {"device": "meta"}
    prog = ssd_scan.cost(torch.empty(bc, q, h, p, **meta),
                         torch.empty(bc, q, h, **meta),
                         torch.empty(bc, q, n, **meta),
                         torch.empty(bc, q, n, **meta))
    assert (prog["flops"], prog["bytes"]) == (flops, nbytes)


def test_busy_and_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert yardstick.union_busy(iv) == 3.0
    assert yardstick.idle_gaps(iv, -1.0, 5.0) == [
        (-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert yardstick.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]
