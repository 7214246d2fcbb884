"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``kernels/csrc/`` compiles on its own into
``kernels/build/<name>-<hash>.so`` the first time a kernel is launched in a
process; the hash covers the source, the headers it may include
(``csrc/*.cuh``) and the flags, so an edited source or header never loads
a stale library. Nothing here runs at import time, so the CPU tests
import every module without a toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["CSRC", "SOURCES", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc",
           "build", "load", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: every kernel source, by name: ``csrc/<name>.cu`` is wrapped by the module
#: ``kernels/<name>.py``
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every shared header ``csrc/*.cuh`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.name.encode() + p.read_bytes()
                       for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns the library's path; raises with nvcc's output on failure."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)                 # atomic: concurrent builds agree
    _LOGS[name] = (f"built {out.name} in {time.perf_counter() - t0:.1f} s\n"
                   f"{proc.stdout}{proc.stderr}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def build_log(name: str) -> Optional[str]:
    """nvcc's output (``-Xptxas=-v`` register and shared-memory report)
    from this process's build of ``name``, or None if it was cached."""
    return _LOGS.get(name)
