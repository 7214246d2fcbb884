"""``kernels/_build.py`` names each kernel library by a hash of its source,
every shared header under ``csrc/`` and the nvcc flags, so an edited source
or header never loads a stale library. Runs without a toolkit, but for the
``cuda`` tests, which compile B3 and B5 with ``nvcc``."""
import re
import subprocess

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text("// no header\n")
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", ["header", "new header", "source"])
def test_an_edit_changes_the_library_path(csrc, edit):
    before = _build._lib_path("a")
    assert _build._lib_path("a") == before
    if edit == "header":
        (csrc / "common.cuh").write_text("// v2\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_text("")
    else:
        (csrc / "a.cu").write_text('#include "common.cuh"\n// v2\n')
    after = _build._lib_path("a")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("a-")


def test_the_replay_kernels_share_their_header():
    """B1 and B2 include ``replay_common.cuh``, which the hash covers."""
    for name in ("schedule_sim", "traffic_sim"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "replay_common.cuh"' in text
    assert (_build.CSRC / "replay_common.cuh").is_file()


def test_the_attention_kernels_share_the_tensor_map_header():
    """B3, B4 and B5 include ``tma_common.cuh`` (tensor maps, mbarriers,
    TMA loads) and define no tensor-map encoder or mbarrier helper of their
    own."""
    import re

    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "tma_common.cuh"' in text
        assert "cuTensorMapEncodeTiled" not in text, name
        assert not re.search(r"\b(encoder|tensor_map|mbar_\w+|tma_load_\w+)"
                             r"\s*\([^;{]*\)\s*\{", text), name
    header = (_build.CSRC / "tma_common.cuh").read_text()
    assert "cuTensorMapEncodeTiled" in header and "mbar_wait" in header


def test_every_kernel_is_found_by_the_profiler():
    """``launch/breakdown.py`` reads each kernel's device time by its symbol:
    every ``__global__`` function under ``csrc/`` matches exactly one of its
    patterns, so a renamed kernel fails here rather than reading 0 ms."""
    import re

    from repro_torch.launch.breakdown import KERNELS

    names = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                            r"(\w+)\s*\(", src.read_text())
    assert len(names) >= 8
    for name in names:
        hits = [key for key, (symbol, _) in KERNELS.items()
                if re.search(symbol, f"void {name}<128>(FlashArgs)")]
        assert len(hits) == 1, (name, hits)


def _ptxas(tmp_path, name):
    """nvcc's ``-Xptxas=-v`` log of ``csrc/<name>.cu``, built apart from the
    library cache; ``{kernel: its properties line}``."""
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc: {e}")
    proc = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(tmp_path / f"{name}.so"),
         str(_build.CSRC / f"{name}.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log
    return log, dict(re.findall(r"Function properties for (\S+)\n\s*(.*)",
                                log))


@pytest.mark.cuda
def test_b3_wgmma_instances_build_without_spills(tmp_path):
    """Every instance of B3's wgmma kernel, head_dim 256 among them,
    compiles with 0 spill bytes: the consumers' O, S and P's two parts fit
    their 240 registers."""
    from repro_torch.kernels import flash_attention as fa

    _, props = _ptxas(tmp_path, "flash_attention")
    found = {int(m.group(1)): line for name, line in props.items()
             if (m := re.search(r"flash_bf16_wgmma_kernelILi(\d+)E", name))}
    assert set(found) == set(fa.WGMMA_HEAD_DIMS)
    for hd, line in found.items():
        assert " 0 bytes spill stores, 0 bytes spill loads" in line, (hd,
                                                                     line)


@pytest.mark.cuda
def test_b5_builds_without_spills_or_serialized_products(tmp_path):
    """Every B5 instance (the wgmma kernel, the mma.sync kernel at each
    column tile) compiles with 0 spill bytes, and ptxas serializes none of
    the wgmma kernel's products (a division, a lambda left as a call, an
    accumulator written between products or a wait in a divergent branch
    each made it do so)."""
    log, props = _ptxas(tmp_path, "ssd_scan")
    kernels = {name: line for name, line in props.items() if "ssd_" in name}
    assert sum("ssd_wgmma_kernel" in n for n in kernels) == 1
    assert sum("ssd_mma_kernel" in n for n in kernels) == 3
    for name, line in kernels.items():
        assert " 0 bytes spill stores, 0 bytes spill loads" in line, (name,
                                                                     line)
    assert "serialized" not in log, log
