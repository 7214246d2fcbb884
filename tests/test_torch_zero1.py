"""ZeRO-1 specs, the train step's specs and the multi-process stream
against the reference, on the CPU.

Mirrors ``tests/test_substrate.py``'s ``zero1_pspecs`` and ``host_slice``
tests, then holds every registered config's ``zero1_pspecs`` and
``make_train_objects(...).specs`` exactly equal to the reference's
``zero1_pspecs`` and ``in_sh`` specs on ``(data, model)`` meshes ``(1,
1)``, ``(2, 1)``, ``(2, 2)``, ``(4, 2)`` and the pod mesh ``(2, 2, 2)``:
a port spec is its reference leaf's without the leading layer axes (the
reference's stacked blocks), as ``tests/test_torch_shard_specs.py``
compares parameter specs. The reference's ``zero1_pspecs`` reads only
``mesh.shape``, so an object with that mapping stands in for a jax
``Mesh``; the port's models are built on ``meta`` on a stand-in device
mesh. The multi-process stream (``make_stream(process_index=,
process_count=)``) is the reference's bit for bit, quirk included: every
process gets the same batch, its tokens the first rows of the one-process
batch's.
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

from repro.configs import get as ref_get
from repro.configs import names
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.data import make_stream as ref_make_stream
from repro.models import build_model as ref_build
from repro.models.model_zoo import batch_pspecs as ref_batch_pspecs
from repro.optim import zero1_pspecs as ref_zero1
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import host_slice, make_stream
from repro_torch.launch.steps import make_train_objects
from repro_torch.models.layers import P
from repro_torch.optim import OptState, zero1_pspecs

MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
IDS = ["x".join(map(str, s)) for s, _ in MESHES]


class PortMesh:
    """What a ``DeviceMesh`` tells a model: axis names, sizes and this
    rank's coordinates (the last rank's)."""

    def __init__(self, shape, names):
        self.mesh_dim_names, self.shape = names, shape

    def get_coordinate(self):
        return [n - 1 for n in self.shape]


class RefMesh:
    """What the reference's models and ``zero1_pspecs`` read of a
    ``jax.sharding.Mesh``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def test_zero1_pspecs_no_duplicate_axes():
    """``tests/test_substrate.py``'s case through the port."""
    sizes = {"data": 1, "model": 1}
    params = {"a": (16, 8), "b": (3,), "c": (4, 4, 4)}
    specs = {"a": P(None, "model"), "b": P(None),
             "c": P("model", "data", None)}
    z = zero1_pspecs(specs, params, sizes, ("data",))
    assert z["a"] == P("data", "model")
    assert z["c"] == P("model", "data", None)
    for spec in z.values():
        flat = [a for e in spec for a in
                (e if isinstance(e, tuple) else (e,)) if a]
        assert len(flat) == len(set(flat))
    want = ref_zero1({k: RefP(*v) for k, v in specs.items()},
                     {k: jax.ShapeDtypeStruct(v, np.float32)
                      for k, v in params.items()},
                     RefMesh((1, 1), ("data", "model")), ("data",))
    assert {k: tuple(v) for k, v in z.items()} == \
        {k: tuple(v) for k, v in want.items()}


def _ref_leaves(tree, path=()):
    """(path without list indices, spec tuple) leaves of a spec tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], path + (k,))
    else:
        yield path, tuple(tree)


def _strip(name, want):
    """The reference leaf of port parameter ``name`` without its leading
    layer axes (one per numeric part of the name)."""
    parts = name.split(".")
    key = tuple(p for p in parts if not p.isdigit())
    lead = len(parts) - len(key)
    return want[key][lead:]


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=IDS)
@pytest.mark.parametrize("arch", list(names()))
def test_zero1_and_train_specs_match_reference(arch, mesh):
    """Every parameter's ZeRO-1 spec, the optimiser state's and the
    batch's specs of ``make_train_objects`` are the reference's."""
    shape, axes = MESHES[mesh]
    daxes = axes[:-1]
    cfg, rcfg = get(arch), ref_get(arch)
    rmesh = RefMesh(shape, axes)
    ref = ref_build(rcfg, mesh=rmesh, data_axes=daxes)
    rspecs = ref.param_pspecs()
    rz = ref_zero1(rspecs, jax.eval_shape(ref.init, jax.random.PRNGKey(0)),
                   rmesh, daxes)
    want = dict(_ref_leaves(rz))
    tshape = ShapeSpec("train", 64, 8, "train")
    model, step, _ = make_train_objects(cfg, tshape, device="meta",
                                        mesh=PortMesh(shape, axes),
                                        data_axes=daxes)
    specs = step.specs
    assert sorted(specs) == ["batch", "opt", "params"]
    opt = specs["opt"]
    assert isinstance(opt, OptState) and tuple(opt.count) == ()
    assert opt.mu == opt.nu and sorted(opt.mu) == sorted(specs["params"])
    whole = step.plan.full
    z = zero1_pspecs(specs["params"], whole, dict(zip(axes, shape)), daxes)
    assert z == opt.mu
    for name, spec in opt.mu.items():
        assert tuple(spec) == _strip(name, want), (name, spec)
    rbatch = ref_batch_pspecs(rcfg, RefShapeSpec("train", 64, 8, "train"),
                              daxes)
    assert {k: tuple(v) for k, v in specs["batch"].items()} == \
        {k: tuple(v) for k, v in rbatch.items()}
    # a rank's moments are its slice of the ZeRO-1 spec
    for name, w in model.named_parameters():
        zs = step.plan.zslice(name, w)
        assert tuple(zs.shape) == model.sh.local_shape(opt.mu[name],
                                                       whole[name]), name


def test_host_slice():
    """``tests/test_substrate.py::test_host_slice``."""
    assert host_slice(16, 0, 4) == slice(0, 4)
    assert host_slice(16, 3, 4) == slice(12, 16)
    with pytest.raises(ValueError):
        host_slice(10, 0, 4)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium",
                                  "internvl2-2b"])
def test_multi_process_stream_is_the_reference_quirk_and_all(arch):
    """Each process's ``batch(i)`` is the reference's bit for bit, and
    every process gets the same batch, its tokens the first ``B/P`` rows
    of the one-process batch's (the frames and vision embeddings, drawn
    after them, other numbers): the processes' batches are not slices of
    the global batch (which is why the mesh ``Trainer`` draws the global
    batch on every rank)."""
    cfg, rcfg = get(arch).reduced(), ref_get(arch).reduced()
    shape = ShapeSpec("t", 32, 4, "train")
    rshape = RefShapeSpec("t", 32, 4, "train")
    whole = make_stream(cfg, shape).batch(3)
    first = None
    for pi in range(2):
        got = make_stream(cfg, shape, process_index=pi,
                          process_count=2).batch(3)
        want = ref_make_stream(rcfg, rshape, process_index=pi,
                               process_count=2).batch(3)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
            assert got[k].shape[0] == 2
        np.testing.assert_array_equal(got["tokens"], whole["tokens"][:2])
        first = first or got
        for k in got:
            np.testing.assert_array_equal(got[k], first[k])
