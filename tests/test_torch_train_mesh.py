"""The train step and the ``Trainer`` on a device mesh against the
reference, on the CPU.

``gloo`` ranks of ``tests/mesh_rank.py train`` (world 2 on ``(2, 1)`` and
``(1, 2)``, world 4 on ``(2, 2)``) run every ``SERVE_CASES`` model
(reduced float32 configs of every family with the fallbacks reached on
purpose, scatter and a2a MoE) through ``loss_fn(local_rows=True)`` on
their rows of a 4-row batch and sum the gradients over the data shards as
the train step does. Each rank's loss is ``jax.value_and_grad`` of the
whole reference model's (rtol 1e-5) and each rank's gradient is its spec's
slice of the reference's (atol 1e-5 + rtol 1e-4 elementwise). a2a on more
than one data shard is held to the port's whole-batch a2a ``loss_fn``
instead, which ``tests/test_torch_moe_a2a.py`` holds to the reference's
a2a: its aux loss is data shard 0's, not the whole batch's.

At world 2 the ranks also run the ``Trainer`` (reduced qwen3, 4 x 64
tokens, 6 steps) from the reference's initial parameters, plain, with
``accum=2`` and with int8 compression, and their losses are the reference
``Trainer``'s at rtol 1e-4 (``tests/test_torch_train_loop.py``'s bar;
compressed: its first step, then the port's one-device trainer's);
each rank's ZeRO-1 moments hold half the elements at ``(2, 1)``. A crash
after step 2's checkpoint on ``(2, 1)`` is restored on ``(1, 2)`` and, in
this process, on a world of one: both land on the clean run's final loss
(rtol 1e-5, as ``tests/test_train_loop.py``).
"""
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mesh_rank import (HELPER, SERVE_CASES, SPAWN_TIMEOUT_S, TRAIN_OPT,
                       TRAIN_RUNS, TRAIN_SHAPE, TRAIN_STEPS, child_env,
                       serve_cfg, train_batch, train_meshes, trainer_for)

from repro.configs import get as ref_get
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.launch.train import Trainer as RefTrainer
from repro.launch.train import TrainerConfig as RefTrainerConfig
from repro.models import build_model as ref_build
from repro.optim import AdamWConfig as RefAdamWConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.models import build_model, params_from_reference

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
WORLDS = (2, 4)
#: cases trained on the same reference parameters: the layouts of one model
SAME_AS = {"moe-ep_fsdp": "moe", "moe-ep_only": "moe", "moe-a2a": "moe"}


def _reference_model(case, seed):
    """The reference model of a case, parameters for it (every leaf of its
    tree N(0, 0.1²) from ``seed``, as ``tests/test_torch_train_step.py``
    draws them: no compile) and the batch."""
    rcfg, _ = serve_cfg(ref_get, case)
    model = ref_build(rcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda sd: (0.1 * rng.standard_normal(sd.shape)).astype(sd.dtype),
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    return model, params, train_batch(rcfg, seed)


def _reference_grads(model, params, batch, cfg):
    """``jax.value_and_grad`` of the unsharded ``loss_fn``: (loss, the
    gradients under the port's names)."""
    (loss, _), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, {k: jnp.asarray(v) for k, v in
                                               batch.items()})
    want = params_from_reference(cfg, jax.tree.map(np.asarray, grads))
    return float(loss), {k: v.numpy() for k, v in want.items()}


def _reference_trainer(**kw):
    """The reference ``Trainer`` (with its initial parameters under the
    port's names): run it with ``.train()``."""
    with jax.threefry_partitionable(False):
        ref = RefTrainer(ref_get("qwen3-0.6b").reduced(),
                         RefShapeSpec("test", *TRAIN_SHAPE, "train"),
                         RefTrainerConfig(steps=TRAIN_STEPS, log_every=1,
                                          **kw),
                         RefAdamWConfig(**TRAIN_OPT))
        params, _ = ref.init_state()
    init = params_from_reference(get("qwen3-0.6b").reduced(),
                                 jax.tree.map(np.asarray, params))
    return ref, {k: v.numpy() for k, v in init.items()}


def _train(ref):
    """The reference ``Trainer``'s metrics."""
    with jax.threefry_partitionable(False):
        return ref.train()["metrics"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The ranks of worlds 2 and 4 (processes, all started together) and
    the reference's gradients and trainers, made while they train."""
    tmp = tmp_path_factory.mktemp("train")
    seeds = {case: i for i, case in enumerate(SERVE_CASES)}
    for case, base in SAME_AS.items():
        seeds[case] = seeds[base]
    models = {case: _reference_model(case, seeds[case])
              for case in SERVE_CASES if case not in SAME_AS}
    # the compressed run's first loss is the plain run's (compression acts
    # on the update); the reference runs the other two
    refs = {run: _reference_trainer(**TRAIN_RUNS[run])
            for run in ("plain", "accum")}
    arrays = {"cases": np.array(list(SERVE_CASES))}
    for case in SERVE_CASES:
        cfg, _ = serve_cfg(get, case)
        _, params, batch = models[SAME_AS.get(case, case)]
        arrays.update({f"{case}.param.{k}": v.numpy() for k, v in
                       params_from_reference(cfg, jax.tree.map(
                           np.asarray, params)).items()})
        arrays.update({f"{case}.batch.{k}": v for k, v in batch.items()})
    arrays.update({f"trainer.param.{k}": v
                   for k, v in refs["plain"][1].items()})
    np.savez(tmp / "in.npz", **arrays)
    procs = {}
    for world in WORLDS:
        (tmp / f"w{world}").mkdir()
        (tmp / f"w{world}" / "in.npz").symlink_to(tmp / "in.npz")
        procs[world] = [subprocess.Popen(
            [sys.executable, str(HELPER), "train", str(r), str(world),
             str(tmp / f"w{world}" / "store"), str(tmp / f"w{world}" / "out"),
             str(tmp / f"w{world}" / "in.npz")], env=child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    try:
        # the reference's compiles on threads of this process (XLA's
        # compiler releases the interpreter lock)
        with ThreadPoolExecutor(4) as pool:
            grads = {case: pool.submit(_reference_grads, model, params, batch,
                                       serve_cfg(get, case)[0])
                     for case, (model, params, batch) in models.items()}
            train = {run: pool.submit(_train, ref)
                     for run, (ref, _) in refs.items()}
            want = {case: f.result() for case, f in grads.items()}
            runs = {run: f.result() for run, f in train.items()}
        for case, base in SAME_AS.items():
            want[case] = want[base]
        one = trainer_for(get, None, compress_grads=True)
        one.init_params = {k: torch.from_numpy(v)
                           for k, v in refs["plain"][1].items()}
        runs["compress-one"] = one.train()["metrics"]
        logs = {w: [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in ps]
                for w, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for world, ps in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"rank {r} of {world}:\n{logs[world][r]}"
    ranks = {w: [dict(np.load(tmp / f"w{w}" / f"out-{r}.npz"))
                 for r in range(w)] for w in WORLDS}
    return want, runs, ranks, tmp / "w2"


CELLS = [(w, "x".join(map(str, s))) for w in WORLDS for s in train_meshes(w)]


@pytest.mark.parametrize("case", list(SERVE_CASES))
@pytest.mark.parametrize("world,mesh", CELLS,
                         ids=[f"mesh{m}" for _, m in CELLS])
def test_mesh_gradients_match_reference(trained, world, mesh, case):
    """Every rank's loss is the whole batch's and its gradients (summed
    over the data shards) are its slices of the reference's."""
    want, _, ranks, _ = trained
    loss, grads = want[case]
    a2a_data = SERVE_CASES[case][2] == "a2a" and mesh[0] != "1"
    for r, o in enumerate(ranks[world]):
        pre = f"{mesh}.{case}"
        if a2a_data:
            loss = float(o[f"{pre}.whole.loss"])
        np.testing.assert_allclose(float(o[f"{pre}.loss"]), loss,
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        names = sorted(k[len(pre) + 3:] for k in o if
                       k.startswith(pre + ".g."))
        assert names == sorted(grads), (r, case)
        for name in names:
            got = o[f"{pre}.g.{name}"]
            if a2a_data:
                w = o[f"{pre}.whole.g.{name}"]
            else:
                idx = tuple(slice(a, b) for a, b in o[f"{pre}.slice.{name}"])
                w = grads[name][idx]
            np.testing.assert_allclose(got, w, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_mesh_trainer_tracks_the_reference_trainer(trained, mesh, run):
    """The ``Trainer`` on the mesh from the reference's initial parameters
    against the reference ``Trainer``: losses and norms at rtol 1e-4, the
    same metrics on every rank; at ``(2, 1)`` each rank's ZeRO-1 moments
    hold half of its parameters' elements. With int8 compression the
    first step is the reference's and the run is the port's on one device
    (which the reference's leaves from the second step on: a gradient's
    last-bit difference can flip its int8 rounding, and Adam's first
    update turns a quantum of difference into a step of ``lr``)."""
    _, runs, ranks, _ = trained
    want = runs["compress-one" if run == "compress" else run]
    if run == "compress":
        np.testing.assert_allclose(ranks[2][0][f"{mesh}.{run}.loss"][0],
                                   runs["plain"][0]["loss"], rtol=1e-4)
    o0 = ranks[2][0]
    for o in ranks[2]:
        assert list(o[f"{mesh}.{run}.step"]) == [m["step"] for m in want]
        np.testing.assert_allclose(o[f"{mesh}.{run}.loss"],
                                   [m["loss"] for m in want], rtol=1e-4)
        np.testing.assert_allclose(o[f"{mesh}.{run}.grad_norm"],
                                   [m["grad_norm"] for m in want],
                                   rtol=1e-4)
        np.testing.assert_allclose(o[f"{mesh}.{run}.lr"],
                                   [m["lr"] for m in want], rtol=1e-6)
        for f in ("loss", "grad_norm", "lr"):
            np.testing.assert_array_equal(o[f"{mesh}.{run}.{f}"],
                                          o0[f"{mesh}.{run}.{f}"])
        share = 2 if mesh == "2x1" else 1
        assert int(o[f"{mesh}.{run}.mu_numel"]) * share == \
            int(o[f"{mesh}.{run}.param_numel"])


def test_crash_on_one_mesh_restores_on_another(trained):
    """Saved on ``(2, 1)`` until a crash at step 3, restored from step 2's
    whole-tensor checkpoint on ``(1, 2)`` and on a world of one: steps 3
    to 5 run again and the final loss is the clean run's."""
    _, _, ranks, wdir = trained
    clean = float(ranks[2][0]["2x1.plain.loss"][-1])
    for o in ranks[2]:
        assert list(o["crashed.step"]) == [0, 1, 2]
        assert list(o["resumed.step"]) == [3, 4, 5]
        np.testing.assert_allclose(o["resumed.loss"][-1], clean,
                                   rtol=LOSS_RTOL)
    back = CheckpointManager(str(wdir / "ckpt-one")).restore(2)
    whole = dict(build_model(get("qwen3-0.6b").reduced(),
                             device="meta").named_parameters())
    assert {n: tuple(t.shape) for n, t in back["params"].items()} == \
        {n: tuple(w.shape) for n, w in whole.items()}
    assert {n: tuple(t.shape) for n, t in back["opt"]["mu"].items()} == \
        {n: tuple(w.shape) for n, w in whole.items()}
    one = trainer_for(get, None, ckpt=str(wdir / "ckpt-one"))
    out = one.train()
    assert [m["step"] for m in out["metrics"]] == [3, 4, 5]
    np.testing.assert_allclose(out["metrics"][-1]["loss"], clean,
                               rtol=LOSS_RTOL)
