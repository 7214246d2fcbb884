"""The port's data stream and input specs against the reference, on the
CPU: mirrors ``tests/test_substrate.py:115-157`` (determinism, resume,
modalities, ``host_slice``, the ``bytes`` source), then every batch bit for
bit against the reference's stream (lm, vlm and enc-dec families, both
sources), and ``input_specs`` against the reference's shapes and dtypes
for every arch and step kind."""
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get as ref_get
from repro.configs import names
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.data import DataConfig as RefDataConfig
from repro.data import make_stream as ref_make_stream
from repro.models import input_specs as ref_input_specs
from repro.models.model_zoo import cache_len_for as ref_cache_len_for
from repro_torch.configs import SHAPES, get
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import DataConfig, host_slice, make_stream
from repro_torch.models import cache_len_for, input_specs

# ---------------------------------------------------------------------------
# mirrors of the reference's tests
# ---------------------------------------------------------------------------


def test_stream_deterministic_and_resumable():
    cfg = get("qwen3-0.6b").reduced()
    shape = ShapeSpec("t", 32, 4, "train")
    s1, s2 = make_stream(cfg, shape), make_stream(cfg, shape)
    for i in (0, 7, 123):
        np.testing.assert_array_equal(s1.batch(i)["tokens"],
                                      s2.batch(i)["tokens"])
    it = s1.at(7)
    np.testing.assert_array_equal(next(it)["tokens"], s2.batch(7)["tokens"])
    assert s1.batch(0)["tokens"].shape == (4, 33)
    assert s1.batch(0)["tokens"].max() < cfg.vocab


def test_stream_modalities():
    shape = ShapeSpec("t", 32, 2, "train")
    enc = make_stream(get("whisper-medium").reduced(), shape).batch(0)
    assert "audio_embeds" in enc and enc["tokens"].shape[1] == 32 // 8 + 1
    vlm = make_stream(get("internvl2-2b").reduced(), shape).batch(0)
    assert "vision" in vlm


def test_host_slice():
    assert host_slice(16, 0, 4) == slice(0, 4)
    assert host_slice(16, 3, 4) == slice(12, 16)
    with pytest.raises(ValueError):
        host_slice(10, 0, 4)


def test_bytes_source(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_text("hello world " * 100)
    cfg = get("qwen3-0.6b").reduced()
    shape = ShapeSpec("t", 16, 2, "train")
    s = make_stream(cfg, shape, DataConfig(source="bytes", path=str(p)))
    b = s.batch(0)["tokens"]
    assert b.shape == (2, 17)
    assert b.max() < 256                       # byte-level


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _same_batches(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-2b",
                                  "whisper-medium", "mamba2-2.7b"])
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_bit_for_bit(arch, seed):
    """Synthetic batches 0, 3 and 1000 of a 2-process stream's second
    host, at the full config's vocab and width."""
    shape = (40, 4)
    got = make_stream(get(arch), ShapeSpec("t", *shape, "train"),
                      DataConfig(seed=seed), process_index=1,
                      process_count=2)
    want = ref_make_stream(ref_get(arch), RefShapeSpec("t", *shape, "train"),
                           RefDataConfig(seed=seed), process_index=1,
                           process_count=2)
    for i in (0, 3, 1000):
        _same_batches(got.batch(i), want.batch(i))
    _same_batches(next(got.at(9)), want.batch(9))


def test_bytes_batches_bit_for_bit(tmp_path):
    p = tmp_path / "corpus.bin"
    p.write_bytes(bytes(np.random.default_rng(0).integers(
        0, 256, 5000).astype(np.uint8)))
    for arch in ("qwen3-0.6b", "whisper-medium"):
        got = make_stream(get(arch), ShapeSpec("t", 64, 3, "train"),
                          DataConfig(seed=2, source="bytes", path=str(p)))
        want = ref_make_stream(ref_get(arch),
                               RefShapeSpec("t", 64, 3, "train"),
                               RefDataConfig(seed=2, source="bytes",
                                             path=str(p)))
        for i in (0, 11):
            _same_batches(got.batch(i), want.batch(i))
    with pytest.raises(ValueError, match="needs a path"):
        make_stream(get("qwen3-0.6b"), ShapeSpec("t", 8, 1, "train"),
                    DataConfig(source="bytes"))


@pytest.mark.parametrize("arch", list(names()))
def test_input_specs_match_reference(arch):
    """Every shape cell of the registry plus a small train shape: the same
    names, shapes and dtypes, as meta tensors; the same cache length."""
    cfg, rcfg = get(arch), ref_get(arch)
    cells = list(zip(SHAPES, REF_SHAPES)) + [
        (ShapeSpec("t", 64, 2, "train"), RefShapeSpec("t", 64, 2, "train"))]
    for shape, rshape in cells:
        got, want = input_specs(cfg, shape), ref_input_specs(rcfg, rshape)
        assert sorted(got) == sorted(want), shape
        for k, t in got.items():
            assert t.device == torch.device("meta")
            assert tuple(t.shape) == want[k].shape, (shape, k)
            assert str(t.dtype)[6:] == str(want[k].dtype), (shape, k)
        assert cache_len_for(cfg, shape) == ref_cache_len_for(rcfg, rshape)
