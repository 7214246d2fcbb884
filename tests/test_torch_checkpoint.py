"""The port's checkpoints and restart supervision on the CPU: mirrors
``tests/test_substrate.py:159-232`` (round trip and keep-N, a ``.tmp``
directory ignored, async saves, failure injection and restarts, the
straggler detector, ``best_mesh_shape``), then bfloat16 leaves bit for
bit, and the on-disk layout read across packages: the reference restores
what the port writes, and the port what the reference writes."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.runtime import best_mesh_shape as ref_best_mesh_shape
from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime import (FailureInjector, SimulatedFailure,
                                 StragglerDetector, best_mesh_shape,
                                 run_with_restarts)

# ---------------------------------------------------------------------------
# mirrors of the reference's tests
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": (torch.tensor(1), [torch.ones(2)])}
    for s in (1, 5, 9):
        mgr.save(s, tree, blocking=True)
    assert mgr.steps() == [5, 9]
    assert mgr.latest_step() == 9
    back = mgr.restore()
    np.testing.assert_array_equal(back["params"]["w"],
                                  np.arange(6.0).reshape(2, 3))
    assert isinstance(back["opt"], tuple)
    assert isinstance(back["opt"][1], list)


def test_checkpoint_ignores_partial_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": torch.zeros(2)}, blocking=True)
    os.makedirs(tmp_path / "step_00000007.tmp")     # crashed save
    assert mgr.latest_step() == 3
    mgr.restore()                                    # no error


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(4)})
    mgr.wait()
    assert mgr.latest_step() == 1


def test_failure_injection_and_restart():
    inj = FailureInjector(fail_at=(2, 5))
    seen = []
    latest = {"v": None}

    def body(start):
        for s in range(start, 8):
            inj.maybe_fail(s)
            seen.append(s)
            latest["v"] = s
        return 7

    assert run_with_restarts(body, lambda: latest["v"]) == 7
    assert seen == [0, 1, 2, 3, 4, 5, 6, 7]   # 2 and 5 retried post-crash


def test_restart_gives_up():
    inj = FailureInjector(p_fail=1.0)

    def body(start):
        inj.maybe_fail(start)
        return start

    with pytest.raises(SimulatedFailure):
        run_with_restarts(body, lambda: None, max_restarts=3)


def test_straggler_detector():
    det = StragglerDetector(warmup=3)
    flags = [det.update(1.0 + 0.01 * i) for i in range(20)]
    assert not any(flags)
    assert det.update(10.0)
    assert det.flagged == 1
    assert det.mean < 2.0


@pytest.mark.parametrize("args", [(512, 16, 2), (256, 16, 1), (7, 2, 1),
                                  (8, 16, 1), (3, 1, 4)])
def test_best_mesh_shape(args):
    """The reference's cases (and two more), equal to the reference."""
    try:
        want = ref_best_mesh_shape(*args)
    except ValueError:
        with pytest.raises(ValueError):
            best_mesh_shape(*args)
        return
    assert best_mesh_shape(*args) == want
    assert best_mesh_shape(512, 16, pod=2) == (2, 16, 16)


# ---------------------------------------------------------------------------
# bfloat16 and the layout
# ---------------------------------------------------------------------------

def test_bfloat16_leaves_round_trip_bit_for_bit(tmp_path):
    """Every bfloat16 bit pattern a training state can hold (NaN payloads,
    infinities, subnormals, -0) comes back as it went, beside float32 and
    int32 leaves; the manifest names bfloat16."""
    words = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).reshape(256, 256)
    bf = words.clone().view(torch.bfloat16)
    tree = {"params": {"w": bf, "v": bf[:3].float()},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree)
    bf.zero_()                        # the snapshot was taken in save()
    mgr.wait()
    back = mgr.restore(4)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"].view(torch.int16), words)
    assert back["opt"]["count"].dtype == torch.int32
    assert int(back["opt"]["count"]) == 7
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert [l["dtype"] for l in leaves] == ["int32", "float32", "bfloat16"]


def test_layout_readable_across_packages(tmp_path):
    """The same tree (dicts, a tuple, a list) saved by each package is
    restored by the other, leaf for leaf, with the same files."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.integers(0, 9, 5).astype(np.int32)}
    port = {"params": {"z": torch.from_numpy(arrays["a"]),
                       "b": torch.from_numpy(arrays["b"])},
            "opt": (torch.tensor(2, dtype=torch.int32),
                    [torch.from_numpy(arrays["a"][0])])}
    ref = {"params": {"z": jnp.asarray(arrays["a"]),
                      "b": jnp.asarray(arrays["b"])},
           "opt": (jnp.asarray(2, jnp.int32), [jnp.asarray(arrays["a"][0])])}
    CheckpointManager(str(tmp_path / "p")).save(1, port, blocking=True)
    RefCheckpointManager(str(tmp_path / "r")).save(1, ref, blocking=True)
    for d in ("p", "r"):
        names = sorted(os.listdir(tmp_path / d / "step_00000001"))
        assert names == ["000000.npy", "000001.npy", "000002.npy",
                         "000003.npy", "manifest.json"]
    with open(tmp_path / "p" / "step_00000001" / "manifest.json") as f:
        mp = json.load(f)
    with open(tmp_path / "r" / "step_00000001" / "manifest.json") as f:
        mr = json.load(f)
    assert mp == mr
    by_ref = RefCheckpointManager(str(tmp_path / "p")).restore()
    by_port = CheckpointManager(str(tmp_path / "r")).restore()
    for tree in (by_ref, by_port):
        np.testing.assert_array_equal(np.asarray(tree["params"]["z"]),
                                      arrays["a"])
        np.testing.assert_array_equal(np.asarray(tree["params"]["b"]),
                                      arrays["b"])
        assert int(np.asarray(tree["opt"][0])) == 2
        np.testing.assert_array_equal(np.asarray(tree["opt"][1][0]),
                                      arrays["a"][0])
