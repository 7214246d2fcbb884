"""Import boundary of the port: ``src/repro_torch`` and ``chip_smoke.py``
never import ``jax`` or the reference package (only the tests import
both), and no kernel wrapper catches a failure to fall back to its plain
version."""
import ast
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
KERNEL_SOURCES = sorted((PORT / "kernels" / "csrc").glob("*.cu"))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_sources_found():
    assert len(SOURCES) > 20 and (REPO / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name


@pytest.mark.parametrize("path", sorted((PORT / "kernels").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernel_wrappers_never_fall_back(path):
    """A CUDA tensor launches the kernel or raises: no ``try`` anywhere in
    the kernel layer could swallow a failure into the plain path."""
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_build_lists_every_kernel_source():
    """``_build.SOURCES`` is what ``chip_smoke.py`` builds and checks: it
    must name every ``csrc/*.cu``."""
    from repro_torch.kernels import _build
    assert _build.SOURCES == tuple(p.stem for p in KERNEL_SOURCES)
    assert len(_build.SOURCES) >= 4


@pytest.mark.parametrize("source", KERNEL_SOURCES, ids=lambda p: p.name)
def test_every_kernel_has_a_wrapper_with_a_launch_counter(source):
    """``csrc/<name>.cu`` is wrapped by ``kernels/<name>.py``, whose one
    dispatch counts its launches."""
    mod = importlib.import_module(f"repro_torch.kernels.{source.stem}")
    counted = [n for n in mod.__all__
               if isinstance(getattr(getattr(mod, n), "launches", None), int)]
    assert len(counted) == 1, (source.name, counted)


#: the planning service's modules (ROADMAP queue A item 10)
SERVICE_MODULES = ("repro_torch.runtime", "repro_torch.runtime.fault",
                   "repro_torch.runtime.straggler",
                   "repro_torch.core.telemetry", "repro_torch.core.plancache",
                   "repro_torch.core.service", "repro_torch.core.traffic")


@pytest.mark.parametrize("name", SERVICE_MODULES)
def test_service_modules_are_scanned(name):
    path = PORT.joinpath(*name.split(".")[1:])
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in SOURCES


def test_service_modules_load_neither_jax_nor_the_reference():
    """Importing the service stack in a fresh interpreter leaves ``jax``
    and every ``repro`` module unloaded."""
    code = ("import sys, importlib\n"
            f"for m in {SERVICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_service_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` is the card: without one, the service raises
    rather than fall back to the CPU."""
    import numpy as np
    import torch

    import repro_torch.core as port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = port.paper_environment()
    dags = [port.zoo.build("alexnet", pin_server=0)]
    trace = port.zero_drift_trace(env, rounds=2)
    for call in (lambda: port.run_service(dags, trace),
                 lambda: port.run_services([dags], trace)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    plans = [np.zeros(dags[0].num_layers, np.int32)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.run_service(dags, trace, initial=[
            port.PSOGAResult(best_x=plans[0], best_fitness=0.0,
                             best_cost=0.0, feasible=True, iterations=0)])


#: the serving families' modules (ROADMAP queue A item 12)
MODEL_MODULES = ("repro_torch.models.moe", "repro_torch.models.encdec",
                 "repro_torch.models.transformer",
                 "repro_torch.models.attention", "repro_torch.launch.serve")


@pytest.mark.parametrize("name", MODEL_MODULES)
def test_model_modules_are_scanned(name):
    assert PORT.joinpath(*name.split(".")[1:]).with_suffix(".py") in SOURCES


def test_model_modules_load_neither_jax_nor_the_reference():
    """Importing the MoE and enc-dec models and the server in a fresh
    interpreter leaves ``jax`` and every ``repro`` module unloaded."""
    code = ("import sys, importlib\n"
            f"for m in {MODEL_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: the device mesh's modules (ROADMAP queue A item 13a)
MESH_MODULES = ("repro_torch.launch.mesh", "repro_torch.runtime.elastic",
                "repro_torch.models.moe", "repro_torch.core.batch")


@pytest.mark.parametrize("name", MESH_MODULES)
def test_mesh_modules_are_scanned(name):
    assert PORT.joinpath(*name.split(".")[1:]).with_suffix(".py") in SOURCES


def test_mesh_modules_load_neither_jax_nor_the_reference():
    """Importing the mesh, the elastic mesh, the a2a MoE and the sharded
    solver in a fresh interpreter leaves ``jax`` and every ``repro``
    module unloaded, and starts no process group."""
    code = ("import sys, importlib\n"
            f"for m in {MESH_MODULES!r}: importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_mesh_defaults_to_the_card(monkeypatch):
    """``device=None`` is the card: without one, building a mesh raises
    rather than start a ``gloo`` world on the CPU."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import resolve_mesh
    from repro_torch.runtime import elastic_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: resolve_mesh("host"),
                 lambda: elastic_mesh(model=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()


#: distribution part 2's modules (ROADMAP queue A item 13b): the specs,
#: the sharded models, their collectives, the step builders and the server
#: on a mesh
SHARD_MODULES = ("repro_torch.core.collectives",
                 "repro_torch.models.layers", "repro_torch.models.attention",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.models.transformer",
                 "repro_torch.models.hybrid", "repro_torch.models.encdec",
                 "repro_torch.models.model_zoo",
                 "repro_torch.models.convert", "repro_torch.launch.mesh",
                 "repro_torch.launch.steps", "repro_torch.launch.serve",
                 "repro_torch.runtime.elastic")


@pytest.mark.parametrize("name", SHARD_MODULES)
def test_shard_modules_are_scanned(name):
    assert PORT.joinpath(*name.split(".")[1:]).with_suffix(".py") in SOURCES


def test_shard_modules_load_neither_jax_nor_the_reference():
    """Importing the sharded models and the server on a mesh in a fresh
    interpreter leaves ``jax`` and every ``repro`` module unloaded, and
    starts no process group."""
    code = ("import sys, importlib\n"
            f"for m in {SHARD_MODULES!r}: importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sharded_server_defaults_to_the_card(monkeypatch):
    """``device=None`` is the card: without one, a server on a model axis
    of 2 raises rather than start a ``gloo`` world on the CPU."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.launch.serve import Server
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(get("qwen3-0.6b").reduced(), 2, 8, 2, model_axis=2)
    assert not dist.is_initialized()


#: the training slice's modules (ROADMAP queue A items 12.6a and 12.6b)
TRAIN_MODULES = ("repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.compression", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.manager",
                 "repro_torch.launch.steps", "repro_torch.launch.train",
                 "repro_torch.runtime.elastic")


@pytest.mark.parametrize("name", TRAIN_MODULES)
def test_train_modules_are_scanned(name):
    path = PORT.joinpath(*name.split(".")[1:])
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in SOURCES


def test_train_modules_load_neither_jax_nor_the_reference():
    """Importing the training slice in a fresh interpreter leaves ``jax``
    and every ``repro`` module unloaded."""
    code = ("import sys, importlib\n"
            f"for m in {TRAIN_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_defaults_to_the_card(monkeypatch):
    """``device=None`` is the card: without one, the trainer, the train
    builder and the CLI raise rather than fall back to the CPU."""
    import torch

    from repro_torch.configs import get
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_objects
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, shape = get("qwen3-0.6b").reduced(), ShapeSpec("t", 16, 2, "train")
    for call in (lambda: train.Trainer(cfg, shape),
                 lambda: make_train_objects(cfg, shape),
                 lambda: train.main(["--arch", "qwen3-0.6b", "--reduced",
                                     "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
