"""The port's expert-parallel MoE dispatch (``moe_apply(impl="a2a")``)
against the reference's, on the CPU.

Reduced mixtral-8x7b (4 experts, top 2, d_model 64), float32. The port
runs as four ``gloo`` ranks of ``tests/mesh_rank.py`` on
``make_test_mesh()``, ``(data 2, model 2)``: each rank holds 2 experts and
takes the global input, and returns the global output. The reference runs
in a subprocess on 4 forced host devices (``XLA_FLAGS`` set for that
process only, as ``tests/test_dryrun.py`` spawns its fleet) on the same
mesh shape. The layer and the whole model (whose ``loss_fn`` runs
tensor-parallel attention beside a2a) hold each rank's slices of their
specs. Both regimes: 64 tokens (every entry kept) and 10,240 (> 8,192:
each lane keeps ``int(1.25 · 2 · 5,120 / (4 · 2))`` = 1,600 entries and
drops the rest, which is why a2a is held to the reference's a2a and not to
scatter). Outputs and the aux loss within 1e-5 (atol and rtol); gradients
of a scalar of the layer's output and of ``loss_fn`` within 1e-4 relative
norm of ``jax.value_and_grad``'s, each against the slice of the
reference's gradient that the reference's spec gives the rank's mesh
coordinate (the slice the rank reports must be the same). On a world of
one (this process) a2a is scatter bit for bit.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from mesh_rank import (HELPER, MOE_SHAPES, SPAWN_TIMEOUT_S, child_env,
                       moe_cfg, moe_inputs, spawn)

from repro.configs import get as ref_get
from repro.models import build_model as ref_build
from repro.models import moe as ref_moe
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.steps import make_prefill_objects
from repro_torch.models import build_model, moe_apply, params_from_reference
from repro_torch.models.moe import MoE

TOL = 1e-5
GRAD_TOL = 1e-4
#: make_test_mesh() on 4 ranks: (data 2, model 2), rank r at (r // 2, r % 2)
MESH = {"data": 2, "model": 2}


class RefMesh:
    """What the reference's spec functions read of the (2, 2) mesh."""
    axis_names = tuple(MESH)
    shape = MESH


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's parameters (one MoE layer's, and a whole model's,
    also under the port's names) and the shared inputs, as an ``.npz``."""
    rcfg, cfg = moe_cfg(ref_get), moe_cfg(get)
    layer = ref_moe.moe_init(jax.random.PRNGKey(1), rcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, ref_build(rcfg).init(
        jax.random.PRNGKey(0)))
    arrays = {**moe_inputs(cfg.d_model, cfg.vocab),
              **{f"layer.{k}": np.asarray(v) for k, v in layer.items()},
              **{f"tree.{k}": v for k, v in _flat(tree)},
              **{f"model.{k}": v.numpy() for k, v in
                 params_from_reference(cfg, tree).items()}}
    path = tmp_path_factory.mktemp("moe") / "in.npz"
    np.savez(path, **arrays)
    return path, arrays


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The reference's a2a (one process, 4 forced host devices) and the
    port's (4 ranks), run side by side."""
    tmp = tmp_path_factory.mktemp("a2a")
    env = child_env(JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_out = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, str(HELPER), "ref-moe", "0", "1", "-",
         str(ref_out), str(inputs[0])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn("moe", 4, tmp, inputs[0])
        log = proc.communicate(timeout=SPAWN_TIMEOUT_S)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    return dict(np.load(ref_out)), ranks


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-30)


def _cut(spec, shape, rank):
    """The slice of a ``shape`` tensor laid out by the reference's
    ``spec`` that rank ``rank`` holds on the (2, 2) mesh (an axis tuple
    splits over the product of its axes, row-major)."""
    coord = {"data": rank // 2, "model": rank % 2}
    idx = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        i, k = 0, 1
        for a in axes:
            i, k = i * MESH[a] + coord[a], k * MESH[a]
        idx.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(idx)


def _check_slice(reported, idx):
    assert [list(p) for p in reported] == [[i.start, i.stop] for i in idx]


def _ref_param_specs():
    """The reference's param_pspecs of the reduced mixtral on the (2, 2)
    mesh, under the port's names' non-index parts: (spec, layer axes)."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out[path + (k,)] = tuple(v)
    walk(ref_build(moe_cfg(ref_get), mesh=RefMesh()).param_pspecs(), ())
    return out


@pytest.mark.parametrize("regime", list(MOE_SHAPES))
def test_a2a_outputs_match_reference(runs, regime):
    want, ranks = runs
    for r, o in enumerate(ranks):
        assert tuple(o["mesh_shape"]) == (2, 2)
        np.testing.assert_allclose(o[f"{regime}.y"], want[f"{regime}.y"],
                                   atol=TOL, rtol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(o[f"{regime}.aux"],
                                   want[f"{regime}.aux"], atol=TOL,
                                   rtol=TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("regime", list(MOE_SHAPES))
def test_a2a_layer_gradients_match_reference(runs, regime):
    """d/d(params, x) of sum(y · w) + 3 · aux: every rank holds the
    reference's gradient (its experts' slice of each bank)."""
    want, ranks = runs
    specs = ref_moe.moe_pspec(moe_cfg(ref_get), MESH["model"])
    for r, o in enumerate(ranks):
        assert _rel(o[f"{regime}.gx"], want[f"{regime}.gx"]) < GRAD_TOL
        for name in ("router", "wi", "wg", "wo"):
            g = want[f"{regime}.g.{name}"]
            idx = _cut(tuple(specs[name]), g.shape, r)
            _check_slice(o[f"layer_slice.{name}"], idx)
            err = _rel(o[f"{regime}.g.{name}"], g[idx])
            assert err < GRAD_TOL, (r, name, err)


def test_a2a_over_two_data_axes_equals_one(runs):
    """On the multi-pod test mesh (pod 2, data 1, model 2) with
    ``data_axes=("pod", "data")`` the tokens split two ways as on the
    (2, 2) mesh over ``("data",)``: outputs, aux and gradients equal bit
    for bit."""
    _, ranks = runs
    for o in ranks:
        for key in o:
            if key.startswith("pod."):
                np.testing.assert_array_equal(o[key], o[key[len("pod."):]],
                                              err_msg=key)
        assert sum(k.startswith("pod.") for k in o) == 2 * 7


def test_a2a_loss_fn_matches_reference(runs):
    """``loss_fn`` of the reduced mixtral under a2a, its attention, MLP
    banks and head tensor-parallel over the model axis: the loss, its aux
    (data shard 0's) and every parameter's gradient (the rank's slice of
    it, as the rank holds the parameter)."""
    want, ranks = runs
    grads = params_from_reference(moe_cfg(get), _unflatten(
        {k[len("tree."):]: want[k] for k in want if k.startswith("tree.")}))
    ref_specs = _ref_param_specs()
    for r, o in enumerate(ranks):
        np.testing.assert_allclose(o["loss"], want["loss"], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(o["loss.aux"], want["loss.aux"],
                                   atol=TOL, rtol=TOL)
        names = [k[len("grad."):] for k in o if k.startswith("grad.")]
        assert sorted(names) == sorted(grads)
        for name in names:
            parts = name.split(".")
            key = tuple(p for p in parts if not p.isdigit())
            spec = ref_specs[key][len(parts) - len(key):]
            g = grads[name].numpy()
            idx = _cut(spec, g.shape, r)
            _check_slice(o[f"slice.{name}"], idx)
            err = _rel(o[f"grad.{name}"], g[idx])
            assert err < GRAD_TOL, (r, name, err)


# ---------------------------------------------------------------------------
# a world of one: a2a is scatter bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world1():
    started = not dist.is_initialized()
    pmesh.init_world("cpu")
    yield pmesh.make_test_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("regime", list(MOE_SHAPES))
def test_a2a_world1_layer_equals_scatter(world1, inputs, regime):
    cfg, arrays = moe_cfg(get), inputs[1]
    p = MoE(cfg, torch.float32, torch.device("cpu"))
    p.load_state_dict({k: torch.tensor(arrays[f"layer.{k}"])
                       for k in ("router", "wi", "wg", "wo")})
    x = torch.tensor(arrays[f"x_{regime}"])
    ys, auxs = moe_apply(p, x, cfg)
    ya, auxa = moe_apply(p, x, cfg, impl="a2a", mesh=world1)
    assert torch.equal(ya, ys) and torch.equal(auxa, auxs)


def test_a2a_world1_model_equals_scatter(world1, inputs):
    """Prefill and 3 greedy decode steps, and ``loss_fn`` with its
    gradients, through the normal builders: a2a on a world of one gives
    scatter's values bit for bit."""
    cfg, arrays = moe_cfg(get), inputs[1]
    state = {k[len("model."):]: torch.tensor(arrays[k])
             for k in arrays if k.startswith("model.")}
    shape = ShapeSpec("prefill", 20, 4, "prefill")     # cache of 20
    models = []
    for impl, mesh in (("scatter", None), ("a2a", world1)):
        m, step, _ = make_prefill_objects(cfg, shape, device="cpu",
                                          mesh=mesh, moe_impl=impl)
        m.load_state_dict(state)
        models.append((m, step))
    batch = {"tokens": arrays["tokens"][:, :16]}
    outs = []
    for m, step in models:
        logits, caches = step(batch)
        seq = [logits]
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        with torch.no_grad():
            for i in range(3):
                lg, caches = m.decode_step(caches, {"token": tok,
                                                    "pos": 16 + i})
                seq.append(lg)
                tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        outs.append(seq)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    grads = []
    for impl, mesh in (("scatter", None), ("a2a", world1)):
        m = build_model(cfg, device="cpu", mesh=mesh, moe_impl=impl)
        m.load_state_dict(state)
        m.requires_grad_(True)
        loss, metrics = m.loss_fn({"tokens": arrays["tokens"]})
        loss.backward()
        grads.append((loss, metrics["aux"],
                      {n: w.grad for n, w in m.named_parameters()}))
    (ls, xs, gs), (la, xa, ga) = grads
    assert torch.equal(ls, la) and torch.equal(xs, xa)
    for n in gs:
        assert torch.equal(gs[n], ga[n]), n
