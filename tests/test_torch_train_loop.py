"""The port's fault-tolerant trainer on the CPU: mirrors
``tests/test_train_loop.py`` (the loss falls, a crash and restart resume
exactly, accumulation equals the full batch, compressed gradients still
train), then both trainers from the reference's initial parameters.

Reduced qwen3-0.6b (float32), 4 x 64 token batches, the reference test's
optimiser settings. The port's losses over 6 steps are held to the
reference ``Trainer``'s at rtol 1e-4: each step's float32 sums run in
another order (gradients within ~4e-6 of the reference's, see
``tests/test_torch_train_step.py``), and an update rounds those
differences into the next step's loss (measured: within 3.4e-7).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.launch.train import Trainer as RefTrainer
from repro.launch.train import TrainerConfig as RefTrainerConfig
from repro.optim import AdamWConfig as RefAdamWConfig
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.models import params_from_reference
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FailureInjector

SHAPE = ShapeSpec("test", 64, 4, "train")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=24, weight_decay=0.01)
ACFG = AdamWConfig(**OPT)


def small_cfg():
    return get("qwen3-0.6b").reduced()


def _trainer(tcfg, **kw):
    return Trainer(small_cfg(), SHAPE, tcfg, ACFG, device="cpu", **kw)


def _losses(out):
    return [m["loss"] for m in out["metrics"]]


# ---------------------------------------------------------------------------
# mirrors of the reference's tests
# ---------------------------------------------------------------------------


def test_loss_decreases():
    out = _trainer(TrainerConfig(steps=15, ckpt_dir=None, log_every=1)
                   ).train()
    losses = _losses(out)
    assert out["final_step"] == 14
    assert losses[-1] < losses[0]


def test_crash_restart_resumes_exactly(tmp_path):
    """An injected crash at step 8 lands on the clean run's final loss:
    the stream is stateless and the checkpoint holds everything else. The
    restart restores step 4's checkpoint and runs steps 5-7 again; on the
    CPU it is bit for bit, step for step."""
    k = dict(steps=12, ckpt_every=4, keep_n=5, log_every=1)
    out_clean = _trainer(TrainerConfig(ckpt_dir=str(tmp_path / "a"), **k)
                         ).train()
    crashy = _trainer(TrainerConfig(ckpt_dir=str(tmp_path / "b"), **k),
                      injector=FailureInjector(fail_at=(8,)))
    out_crash = crashy.train()
    assert out_clean["final_step"] == out_crash["final_step"] == 11
    l1 = [m for m in out_clean["metrics"] if m["step"] == 11][0]["loss"]
    l2 = [m for m in out_crash["metrics"] if m["step"] == 11][0]["loss"]
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    steps = [m["step"] for m in out_crash["metrics"]]
    assert steps == list(range(8)) + list(range(5, 12))
    crash = _losses(out_crash)
    assert crash[:8] + crash[11:] == _losses(out_clean)
    assert crash[5:8] == crash[8:11]
    assert crashy.mgr.steps() == [0, 4, 8, 11]


def test_grad_accumulation_matches_full_batch():
    """accum=2 over the same global batch ~= accum=1 (mean of grads)."""
    o1 = _trainer(TrainerConfig(steps=6, accum=1, log_every=1)).train()
    o2 = _trainer(TrainerConfig(steps=6, accum=2, log_every=1)).train()
    np.testing.assert_allclose(_losses(o1), _losses(o2), rtol=2e-3)


def test_compressed_grads_still_train(tmp_path):
    t = _trainer(TrainerConfig(steps=12, compress_grads=True, log_every=1,
                               ckpt_dir=str(tmp_path), ckpt_every=6))
    losses = _losses(t.train())
    assert losses[-1] < losses[0]
    back = t.mgr.restore()
    assert sorted(back) == ["comp", "opt", "params"]
    assert sorted(back["comp"]) == sorted(t.params)


# ---------------------------------------------------------------------------
# against the reference trainer; the CLI
# ---------------------------------------------------------------------------


def test_losses_track_the_reference_trainer():
    """Both trainers start from the reference's ``model.init(PRNGKey(0))``
    (its own ``init_state``, carried into the port as ``init_params``) and
    take 6 steps on the same stream."""
    with jax.threefry_partitionable(False):
        ref = RefTrainer(ref_get("qwen3-0.6b").reduced(),
                         RefShapeSpec("test", 64, 4, "train"),
                         RefTrainerConfig(steps=6, log_every=1),
                         RefAdamWConfig(**OPT))
        params, _ = ref.init_state()
        want = ref.train()
    cfg = small_cfg()
    init = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    got = _trainer(TrainerConfig(steps=6, log_every=1),
                   init_params=init).train()
    assert got["final_step"] == want["final_step"] == 5
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-4)
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)


def test_cli_trains_on_the_cpu(capsys):
    train_cli.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[train] step 2 loss" in out
    assert "[train] done: final_step=2 stragglers=0" in out


def test_model_axis_and_missing_card_raise(monkeypatch):
    """A model axis of 2 trains on ``elastic_mesh(model=2)`` over the
    world's ranks: a world of one cannot host it (``tests/
    test_torch_train_mesh.py`` trains on meshes of 2 and 4 ranks)."""
    import torch.distributed as dist
    started = dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="cannot host model=2"):
            _trainer(TrainerConfig(model_axis=2))
    finally:
        if dist.is_initialized() and not started:
            dist.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.trainer_from_args(train_cli.parse_args(
            ["--arch", "qwen3-0.6b", "--reduced"]))
