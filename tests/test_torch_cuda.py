"""The CUDA replay kernels against their plain PyTorch versions, on a card.

Run where there is one (no JAX needed):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips with its reason: the kernels have no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (SimProblem, heft_makespan, merge_dags,
                              pack_arrivals, pad_problem, paper_environment,
                              sample_arrivals, stack_problems, traffic_inputs,
                              zoo)
from repro_torch.core.simulator import kernel_args
from repro_torch.kernels import schedule_sim, traffic_sim

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


def _traffic_bucket(device, M=3, R=8):
    """alexnet + googlenet problems (two apps each, deadlines 5 x HEFT,
    padded to one bucket) under M bursty draws; the second app of problem
    0 gets no request in draw 0 (every slot +inf)."""
    env = paper_environment()
    probs = []
    for i, net in enumerate(("alexnet", "googlenet")):
        dag = merge_dags([zoo.build(net, pin_server=i + 2 * k)
                          for k in range(2)])
        h, _ = heft_makespan(dag, env)
        probs.append(SimProblem.build(dag.with_deadline(np.full(2, 5.0 * h)),
                                      env))
    ppb = stack_problems([
        pad_problem(pr, max_p=256, max_S=32, max_in=4, max_out=4,
                    max_apps=3, device=device) for pr in probs])
    arrs = [sample_arrivals("bursty", 2, rate=0.5, horizon=30.0,
                            max_requests=R, n_seeds=M, seed=i).t
            for i in range(2)]
    arrs[0][0, 1] = np.inf
    return probs, ppb, pack_arrivals(arrs, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
def test_traffic_kernel_matches_plain_on_card(cuda_device, faithful):
    """B2 on a fleet bucket, M = 3 draws, an all-+inf app, P not a multiple
    of the block: static_ok and miss rates exact, costs, latency sums and
    the latency grid to rtol 1e-5, one launch."""
    rng = np.random.default_rng(12)
    probs, ppb, arr = _traffic_bucket(cuda_device)
    tin = traffic_inputs(ppb, arr)
    Xb = np.zeros((2, 130, 256), np.int32)
    for n, pr in enumerate(probs):
        Xb[n, :, :pr.num_layers] = rng.integers(
            0, pr.num_servers, size=(130, pr.num_layers))
        Xb[n, :65, :pr.num_layers] = 15
        pins = np.flatnonzero(pr.pinned >= 0)
        Xb[n][:, pins] = pr.pinned[pins]
    X = torch.as_tensor(Xb, device=cuda_device)
    shape = (2, 3, 130, 3, 8)
    lat_k = torch.empty(shape, device=cuda_device)
    lat_p = torch.empty(shape, device=cuda_device)
    before = traffic_sim.traffic_replay.launches
    got = traffic_sim.traffic_replay(*kernel_args(ppb), X, *tin,
                                     faithful=faithful, latency=lat_k)
    torch.cuda.synchronize()
    assert traffic_sim.traffic_replay.launches == before + 1
    want = traffic_sim.traffic_replay_plain(*kernel_args(ppb), X, *tin,
                                            faithful=faithful, latency=lat_p)
    assert torch.equal(got[3], want[3]) and got[3].any()
    assert torch.equal(got[1], want[1])
    for k in (0, 2, 4):
        torch.testing.assert_close(got[k], want[k], rtol=RTOL, atol=0)
    assert (lat_k[0, 0, :, 1] == 0).all()          # the all-+inf app
    assert (got[1] > 0).any() and (got[1] < 1).any()


@pytest.mark.cuda
def test_traffic_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    _, ppb, arr = _traffic_bucket(cuda_device)
    tin = traffic_inputs(ppb, arr)
    X = torch.zeros((2, 8, 256), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        traffic_sim.traffic_replay(*kernel_args(ppb), X,
                                   *tin._replace(arr_m=tin.arr_m.double()))
    with pytest.raises(ValueError):
        traffic_sim.traffic_replay(*kernel_args(ppb), X,
                                   *tin._replace(n_valid=tin.n_valid[:, :2]))
    with pytest.raises(ValueError):
        traffic_sim.traffic_replay(*kernel_args(ppb), X, *tin,
                                   latency=torch.empty((2, 3, 8, 3, 7),
                                                       device=cuda_device))
    with pytest.raises(ValueError, match="M >= 1"):
        traffic_sim.traffic_replay(*kernel_args(ppb), X,
                                   *(t[:, :0] for t in tin))
