"""The CUDA replay kernel against its plain PyTorch version, on a card.

Run where there is one (no JAX needed):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips with its reason: the kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (SimProblem, pad_problem, paper_environment,
                              stack_problems, zoo)
from repro_torch.core.simulator import kernel_args
from repro_torch.kernels import schedule_sim

RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _fleet(device, max_apps=1):
    env = paper_environment()
    probs = [SimProblem.build(zoo.build(net, pin_server=i), env)
             for i, net in enumerate(zoo.NAMES)]
    return probs, stack_problems([
        pad_problem(pr, max_p=512, max_S=32, max_in=4, max_out=4,
                    max_apps=max_apps, device=device) for pr in probs])


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, faithful):
    """A padded fleet bucket of zoo DNNs, P not a multiple of the block:
    feasible exact, costs and completion sums to rtol 1e-5, one launch."""
    rng = np.random.default_rng(11)
    probs, ppb = _fleet(cuda_device, max_apps=3)
    Xb = np.zeros((len(probs), 130, 512), np.int32)
    for n, pr in enumerate(probs):
        Xb[n, :, :pr.num_layers] = rng.integers(
            0, pr.num_servers, size=(130, pr.num_layers))
        Xb[n, :65, :pr.num_layers] = 15          # an edge server: feasible
        Xb[n, :, 0] = n                          # the pinned input layer
    X = torch.as_tensor(Xb, device=cuda_device)
    before = schedule_sim.schedule_replay.launches
    got = schedule_sim.schedule_replay(*kernel_args(ppb), X,
                                       faithful=faithful)
    torch.cuda.synchronize()
    assert schedule_sim.schedule_replay.launches == before + 1
    want = schedule_sim.schedule_replay_plain(*kernel_args(ppb), X,
                                              faithful=faithful)
    assert torch.equal(got[1], want[1])
    assert got[1].any() and not got[1].all()
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    _, ppb = _fleet(cuda_device)
    args = list(kernel_args(ppb))
    X = torch.zeros((4, 8, 512), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        schedule_sim.schedule_replay(*args, X.to(torch.int64))
    with pytest.raises(ValueError):
        schedule_sim.schedule_replay(*args, X[:, :, :256])
    with pytest.raises(ValueError):
        schedule_sim.schedule_replay(*args, X.transpose(1, 2).contiguous()
                                     .transpose(1, 2))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError):
        schedule_sim.schedule_replay(*args, X)
