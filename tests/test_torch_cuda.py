"""The CUDA kernels against their plain PyTorch versions, on a card: the
replay kernels B1 and B2, the attention kernels B3 and B4, the SSD
intra-chunk kernel B5, every model family through them (the int8 KV cache
included), the comparators (GA, linear-inertia PSO, prePSO) and one
re-planning round through B1 and B2, B1's wrapper under two threads at
once (as ``run_services`` drives it), every family on an ``nccl`` mesh of
one against the meshless model, and training: one train step of
every family on the card against the CPU's (no kernel launched), and the
kernels' refusal of inputs that require grad.

Run where there is one (no JAX needed):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips with its reason: the kernels have no CPU mode.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import (GAConfig, GADraws, PSOGAConfig, ReplanConfig,
                              SimProblem, TrafficConfig, greedy_offload,
                              heft_makespan, init_swarm, merge_dags, pack_arrivals,
                              pad_problem, paper_environment, pre_pso,
                              replan_round, run_ga, run_pso_linear,
                              sample_arrivals, sample_trace, stack_problems,
                              traffic_inputs, zoo)
from repro_torch.core.batch import SYNC_EVERY
from repro_torch.core.dag import preprocess
from repro_torch.core.pso_ga import draws_from_uniforms
from repro_torch.core.simulator import kernel_args
from repro_torch.configs import get
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, schedule_sim, ssd_scan, traffic_sim
from repro_torch.launch.serve import request_batch
from repro_torch.models import TransformerLM, build_model

RTOL = 1e-5
#: attention kernels vs plain: the reference kernel tests' tolerances
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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


def _deep_bucket(device):
    """Three problems of different true sizes whose parents reach beyond
    the walk's ring of end times: a 300-layer chain with skip edges up to
    250 steps back, a 150-layer random DAG (parents drawn from every
    earlier layer) with two apps, and googlenet; one padded bucket."""
    from repro_torch.core import LayerDAG
    rng = np.random.default_rng(21)
    n = 300
    edges = [(j, j + 1) for j in range(n - 1)] + [
        (u, u + d) for u, d in ((0, 250), (5, 100), (40, 33), (100, 199))]
    chain = LayerDAG(compute=rng.uniform(0.1, 3.0, n),
                     edges=np.asarray(edges, np.int32),
                     edge_mb=rng.uniform(0.05, 2.0, len(edges)),
                     app_id=np.zeros(n, np.int32), deadline=np.array([1e4]),
                     pinned=np.r_[0, np.full(n - 1, -1)].astype(np.int32))
    m = 150
    redges = [(int(u), j) for j in range(1, m)
              for u in rng.choice(j, size=min(j, 3), replace=False)]
    rand = LayerDAG(compute=rng.uniform(0.1, 3.0, m),
                    edges=np.asarray(redges, np.int32),
                    edge_mb=rng.uniform(0.05, 2.0, len(redges)),
                    app_id=(np.arange(m) >= 70).astype(np.int32),
                    deadline=np.array([1e3, 2e3]),
                    pinned=np.full(m, -1, np.int32))
    env = paper_environment()
    probs = [SimProblem.build(d, env)
             for d in (chain, rand, zoo.build("googlenet", pin_server=1))]
    sizes = [pad_problem(pr, device=device) for pr in probs]
    ppb = stack_problems([pad_problem(
        pr, max_p=n, max_S=32, max_apps=2,
        max_in=max(s.parent_idx.shape[-1] for s in sizes),
        max_out=max(s.child_idx.shape[-1] for s in sizes), device=device)
        for pr in probs])
    return probs, ppb


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("P", [100, 129])
def test_kernel_matches_plain_beyond_the_ring(cuda_device, P, faithful):
    """Parents beyond the ring (the far route) in a stacked bucket of three
    problems of different sizes, P = 100 and 129 (neither a multiple of
    the 32-particle block): feasible exact, totals and completion sums to
    rtol 1e-5, one counted call."""
    rng = np.random.default_rng(P)
    probs, ppb = _deep_bucket(cuda_device)
    args = kernel_args(ppb)
    meta = schedule_sim.step_tables(args[0], args[2], args[6])
    assert bool((meta[..., 1:] > schedule_sim.RING).any())
    Xb = np.zeros((3, P, ppb.max_layers), np.int32)
    for n, pr in enumerate(probs):
        Xb[n, :, :pr.num_layers] = rng.integers(
            0, pr.num_servers, size=(P, pr.num_layers))
        # one server throughout (an edge server for googlenet, the pinned
        # end device for the others): feasible
        Xb[n, :P // 2, :pr.num_layers] = 15 if n == 2 else 0
        pins = np.flatnonzero(pr.pinned >= 0)
        Xb[n][:, pins] = pr.pinned[pins]
    X = torch.as_tensor(Xb, device=cuda_device)
    before = schedule_sim.schedule_replay.launches
    got = schedule_sim.schedule_replay(*args, X, faithful=faithful)
    torch.cuda.synchronize()
    assert schedule_sim.schedule_replay.launches == before + 1
    want = schedule_sim.schedule_replay_plain(*args, X, faithful=faithful)
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
    got = _traffic_against_plain(kernel_args(ppb), X, tin, faithful)
    assert got[3].any()
    assert (got[4][0, 0, :, 1] == 0).all()         # the all-+inf app
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


def _deep_traffic(device, M=3, R=8):
    """``_deep_bucket`` under bursty draws: the merged orders read parents
    beyond the walk's ring, and the random DAG's edges between its two
    apps join requests that arrive apart (parents that have not run)."""
    probs, ppb = _deep_bucket(device)
    arrs = [sample_arrivals("bursty", pr.num_apps, rate=0.5, horizon=30.0,
                            max_requests=R, n_seeds=M, seed=40 + i).t
            for i, pr in enumerate(probs)]
    return probs, ppb, traffic_inputs(ppb, pack_arrivals(arrs, 2))


def _traffic_swarm(rng, probs, P, max_p, device, home):
    """Random genes; the first half on server ``home[n]`` throughout, then
    every pin honoured."""
    Xb = np.zeros((len(probs), P, max_p), np.int32)
    for n, pr in enumerate(probs):
        Xb[n, :, :pr.num_layers] = rng.integers(
            0, pr.num_servers, size=(P, pr.num_layers))
        Xb[n, :P // 2, :pr.num_layers] = home[n]
        pins = np.flatnonzero(pr.pinned >= 0)
        Xb[n][:, pins] = pr.pinned[pins]
    return torch.as_tensor(Xb, device=device)


def _traffic_against_plain(args, X, tin, faithful, grid=True):
    """B2 and its plain version on the same CUDA tensors: one counted
    call; static_ok and miss rates exact, the rest to rtol 1e-5."""
    N, P = X.shape[:2]
    M, A, R = tin.arr2.shape[1:]
    lat_k, lat_p = (torch.full((N, M, P, A, R), float("nan"),
                               device=X.device) if grid else None
                    for _ in range(2))
    before = traffic_sim.traffic_replay.launches
    got = traffic_sim.traffic_replay(*args, X, *tin, faithful=faithful,
                                     latency=lat_k)
    torch.cuda.synchronize()
    assert traffic_sim.traffic_replay.launches == before + 1
    want = traffic_sim.traffic_replay_plain(*args, X, *tin,
                                            faithful=faithful, latency=lat_p)
    assert torch.equal(got[3], want[3])
    assert torch.equal(got[1], want[1])
    for k in ((0, 2, 4) if grid else (0, 2)):
        torch.testing.assert_close(got[k], want[k], rtol=RTOL, atol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("P", [100, 129])
def test_traffic_kernel_matches_plain_beyond_the_ring(cuda_device, P,
                                                      faithful):
    """B2 on the deep bucket (300-, 150- and 83-layer problems) under
    M = 3 bursty draws of R = 8 requests: parent reads beyond the ring of
    end times, parents not yet run, P not a multiple of the warp."""
    probs, ppb, tin = _deep_traffic(cuda_device)
    args = kernel_args(ppb)
    meta = traffic_sim.traffic_step_tables(args[0], args[2], args[6],
                                           tin.slot_m, tin.n_valid, 8)
    assert bool((meta[..., 2:] > traffic_sim.RING).any())
    assert bool((meta[..., 2:] == -1).any())
    X = _traffic_swarm(np.random.default_rng(P), probs, P, ppb.max_layers,
                       cuda_device, home=(0, 0, 15))
    got = _traffic_against_plain(args, X, tin, faithful)
    assert got[3].any() and (got[1] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
def test_traffic_kernel_at_the_held_out_shape(cuda_device, faithful):
    """A held-out report's launch: one plan (P = 1), M = 16 evaluation
    draws, the latency grid."""
    probs, ppb, _ = _traffic_bucket(cuda_device)
    pp = pad_problem(probs[1], device=cuda_device)
    arr = TrafficConfig(kind="bursty").eval_arrivals(probs[1].num_apps,
                                                     seed=5)
    tin = traffic_inputs(pp, arr)
    X = _traffic_swarm(np.random.default_rng(3), probs[1:], 1,
                       pp.max_layers, cuda_device, home=(15,))
    assert tin.n_valid.shape == (1, 16)
    _traffic_against_plain(kernel_args(pp), X, tin, faithful)


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
def test_traffic_kernel_with_an_empty_draw(cuda_device, faithful):
    """A (problem, draw) lane with no request at all (n_valid = 0) beside
    full ones: zero cost, latency and miss rate, as the plain version."""
    probs, ppb, arr = _traffic_bucket(cuda_device)
    arr = arr.copy()
    arr[1, 2] = np.inf
    tin = traffic_inputs(ppb, arr)
    assert int(tin.n_valid[1, 2]) == 0 and int(tin.n_valid.min()) == 0
    X = _traffic_swarm(np.random.default_rng(4), probs, 40, 256,
                       cuda_device, home=(15, 15))
    got = _traffic_against_plain(kernel_args(ppb), X, tin, faithful)
    assert (got[0][1, 2] == 0).all() and (got[4][1, 2] == 0).all()


@pytest.mark.cuda
def test_replay_kernels_check_the_pins_of_padded_genes(cuda_device):
    """A pin on a padded layer (no padded problem has one) is checked
    gene by gene, as the plain versions' ``pin_ok``: B1 and B2 agree."""
    probs, ppb, arr = _traffic_bucket(cuda_device)
    args = list(kernel_args(ppb))
    pinned = args[8].clone()
    pinned[0, 250] = 3
    args[8] = pinned
    X = _traffic_swarm(np.random.default_rng(5), probs, 40, 256,
                       cuda_device, home=(15, 15))
    X[0, ::2, 250] = 3
    got = _traffic_against_plain(args, X, traffic_inputs(ppb, arr), False)
    assert got[3][0].any() and not got[3][0, 1::2].any()
    for faithful in (True, False):
        g = schedule_sim.schedule_replay(*args, X, faithful=faithful)
        w = schedule_sim.schedule_replay_plain(*args, X, faithful=faithful)
        assert torch.equal(g[1], w[1])


@pytest.mark.cuda
def test_traffic_wrapper_refuses_a_geometry_mismatch(cuda_device,
                                                     monkeypatch):
    """The wrapper's ring, tile and copy distance must be the kernel's."""
    _, ppb, arr = _traffic_bucket(cuda_device)
    X = torch.zeros((2, 8, 256), dtype=torch.int32, device=cuda_device)
    monkeypatch.setattr(traffic_sim, "_LIB", None)
    monkeypatch.setattr(traffic_sim, "RING", 2 * traffic_sim.RING)
    with pytest.raises(RuntimeError, match="ring, tile and copy distance"):
        traffic_sim.traffic_replay(*kernel_args(ppb), X,
                                   *traffic_inputs(ppb, arr))


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,kh,g,hd,causal,window", [
    (1, 300, 1, 4, 64, True, 0),       # ragged seq, GQA
    (2, 257, 2, 1, 128, True, 64),     # odd seq, sliding window
    (2, 200, 2, 2, 16, True, 0),       # the reduced configs' head_dim
    (1, 100, 2, 3, 256, True, 7),      # gemma-7b's head_dim (wgmma)
    (1, 130, 1, 2, 128, False, 0),     # bidirectional
    (2, 300, 4, 1, 112, True, 0),      # zamba2's head_dim
    (1, 200, 2, 2, 112, True, 64),
    (8, 2048, 8, 2, 128, True, 0),     # qwen3-0.6b's serving prefill
    (8, 2048, 32, 1, 112, True, 0),    # zamba2-7b's serving prefill
    # rows 191.. of the second q tile see nothing of their first kv tile
    (1, 512, 2, 2, 64, True, 64),
    (1, 700, 1, 2, 128, False, 100),   # bidirectional with a window
    (8, 2048, 16, 2, 128, True, 1024),  # gemma3-27b's local layers
    (8, 1500, 16, 1, 64, False, 0),    # whisper-medium's encoder
    (8, 187, 16, 1, 64, True, 0),      # whisper-medium's decoder prefill
    # the edges of the wgmma route's 128-row q and kv tiles
    (1, 1, 2, 2, 128, True, 0),        # one token
    (2, 17, 2, 2, 64, True, 0),        # seq inside one q tile
    (1, 256, 2, 2, 128, True, 0),      # seq of whole tiles
    (1, 300, 2, 2, 128, True, 7),      # a window inside one kv tile
    (1, 300, 2, 3, 128, True, 0),      # G 3
    (1, 300, 1, 4, 128, True, 0),      # G 4
    (2, 129, 2, 1, 64, False, 0),      # one row past a tile, bidirectional
    (1, 129, 2, 2, 112, True, 0),      # one row past a tile at hd 112
    # head_dim 256 on the wgmma route (80-row kv tiles) and G 12 at 128
    (8, 2048, 16, 1, 256, True, 0),    # gemma-7b's serving prefill
    (1, 1, 2, 2, 256, True, 0),        # one token
    (1, 129, 2, 2, 256, True, 0),      # one row past a q tile
    (1, 700, 1, 2, 256, True, 100),    # a window across kv tiles
    (2, 300, 1, 3, 256, False, 0),     # bidirectional, G 3, ragged
    (2, 333, 3, 3, 256, True, 100),    # K 3, G 3, a window, ragged
    (8, 2048, 2, 12, 128, True, 0),    # starcoder2-3b's serving prefill
])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, b, s, kh, g,
                                            hd, causal, window):
    """B3 through the model-layout wrapper, one launch, against
    ``flash_attention_plain`` on the same CUDA tensors."""
    q = _randn((b, s, kh, g, hd), dtype, cuda_device, 1)
    k = _randn((b, s, kh, hd), dtype, cuda_device, 2)
    v = _randn((b, s, kh, hd), dtype, cuda_device, 3)
    before = fa.flash_attention_folded.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_folded.launches == before + 1
    assert got.is_contiguous() and got.dtype == dtype
    want = fa.flash_attention_plain(q.permute(0, 2, 3, 1, 4),
                                    k.permute(0, 2, 1, 3),
                                    v.permute(0, 2, 1, 3), causal=causal,
                                    window=window).permute(0, 3, 1, 2, 4)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_host_route_and_tiles_match_the_library(cuda_device, hd):
    """The host's ``route`` and ``tile_geometry`` for bf16 are what the
    built kernel library runs: the CPU emulation follows the same tiles."""
    for r in ("mma", "wgmma"):
        want = (fa.tile_geometry(hd, torch.bfloat16)
                if fa.route(hd, torch.bfloat16) == r else None)
        assert fa.library_tiles(hd, r) == want, (hd, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,kh,g,hd,valid", [
    (2, 100, 1, 8, 64, 1),             # single live slot, two head groups
    (1, 1000, 2, 2, 64, 999),          # ragged cache
    (2, 2080, 8, 2, 128, 2048),        # qwen3's serving cache
    (1, 64, 2, 3, 16, 64),             # full cache, G not a power of two
    (1, 300, 1, 1, 256, 77),
    (2, 2080, 4, 1, 112, 2049),        # zamba2's head_dim
    (1, 100, 2, 3, 112, 1),
    # qwen3-0.6b's serving cache at valid 1, 7, one tile, one split of the
    # serving length (256 of 2048 over 8 blocks) and the whole cache
    (8, 2080, 8, 2, 128, 1),
    (8, 2080, 8, 2, 128, 7),
    (8, 2080, 8, 2, 128, 64),
    (8, 2080, 8, 2, 128, 256),
    (8, 2080, 8, 2, 128, 2080),
    (8, 2080, 32, 1, 112, 2048),       # zamba2-7b's serving cache
    (1, 600, 1, 1, 128, 520),          # 8 blocks, the last ones empty
    (1, 600, 1, 6, 64, 599),           # G 6: two head groups of 4
    (8, 1024, 16, 2, 128, 1024),       # gemma3-27b's full local ring
    (8, 1532, 16, 1, 64, 1501),        # whisper-medium's self cache
    (8, 1532, 16, 1, 64, 1532),
    (8, 2080, 16, 1, 256, 2048),       # gemma-7b's serving cache
    (8, 2080, 2, 12, 128, 2048),       # starcoder2-3b's: G 12, groups 8 + 4
])
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, b, c, kh,
                                             g, hd, valid):
    """B4 reading the (B, C, K, hd) cache in place, one launch, against
    ``decode_attention_plain``; dead slots hold +-1e9."""
    q = _randn((b, kh, g, hd), dtype, cuda_device, 4)
    k = _randn((b, c, kh, hd), dtype, cuda_device, 5)
    v = _randn((b, c, kh, hd), dtype, cuda_device, 6)
    k[:, valid:] = 1e9
    v[:, valid:] = -1e9
    before = da.decode_attention_folded.launches
    got = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert da.decode_attention_folded.launches == before + 1
    want = da.decode_attention_plain(q, k.permute(0, 2, 1, 3),
                                     v.permute(0, 2, 1, 3), valid)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid,blocks", [(1, 8), (7, 8), (200, 8),
                                          (200, 1), (300, 5), (300, 1000)])
def test_decode_kernel_forced_splits_match_plain(cuda_device, dtype, valid,
                                                 blocks):
    """B4 forced onto a grid of ``blocks`` (at most one a tile): rows
    shared by several blocks merge through the workspace, a block's range
    may cross rows."""
    q = _randn((2, 2, 3, 128), dtype, cuda_device, 7)
    k = _randn((2, 300, 2, 128), dtype, cuda_device, 8)
    v = _randn((2, 300, 2, 128), dtype, cuda_device, 9)
    k[:, valid:] = 1e9
    v[:, valid:] = -1e9
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    got = da.decode_attention_folded(q, ks, vs, valid, blocks=blocks)
    torch.cuda.synchronize()
    want = da.decode_attention_plain(q, ks, vs, valid)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,kh,g,hd,valid,blocks", [
    (1, 1040, 8, 2, 128, 1, None),     # qwen3-0.6b's slice of 2,080 slots
    (1, 1040, 8, 2, 128, 1000, None),  # ends inside a tile
    (1, 1040, 8, 2, 128, 1040, None),
    (1, 1040, 32, 1, 112, 777, None),  # zamba2-7b's head_dim
    (1, 512, 16, 2, 128, 512, None),   # a half of gemma3's ring of 1,024
    (2, 300, 2, 6, 64, 199, 5),        # G 6 in a group of 8, forced grid
    (1, 8200, 8, 2, 128, 8200, None),  # qwen3's 1 x 8,200 rank slice
])
def test_decode_kernel_lse_matches_plain(cuda_device, dtype, b, c, kh, g,
                                         hd, valid, blocks):
    """B4 with ``return_lse``: one launch, the output as without it, and
    each head's log-sum-exp of its live scores against the plain
    version's ``torch.logsumexp`` (float32 throughout: 2e-5 absolute at
    either dtype, the scores being the same products)."""
    q = _randn((b, kh, g, hd), dtype, cuda_device, 11)
    k = _randn((b, c, kh, hd), dtype, cuda_device, 12)
    v = _randn((b, c, kh, hd), dtype, cuda_device, 13)
    k[:, valid:] = 1e9
    v[:, valid:] = -1e9
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    before = da.decode_attention_folded.launches
    got, lse = da.decode_attention_folded(q, ks, vs, valid, blocks=blocks,
                                          return_lse=True)
    alone = da.decode_attention_folded(q, ks, vs, valid, blocks=blocks)
    torch.cuda.synchronize()
    assert da.decode_attention_folded.launches == before + 2
    assert lse.dtype == torch.float32 and lse.shape == (b, kh, g)
    torch.testing.assert_close(got, alone, rtol=0, atol=0)
    want, want_lse = da.decode_attention_plain(q, ks, vs, valid,
                                               return_lse=True)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,kh,g,hd,valid,blocks", [
    (1, 4000, 1, 2, 128, 4000, None),  # one row over many blocks
    (3, 300, 2, 2, 64, 200, 5),        # ranges that cross rows
    (2, 600, 2, 2, 128, 1, None),      # valid 1: three warps' shares empty
    (2, 600, 2, 2, 128, 20, 3),        # valid inside the first tile
    (2, 300, 2, 3, 128, 250, None),    # G 3
    (2, 300, 1, 8, 64, 299, 7),        # G 8
    (2, 300, 1, 12, 64, 299, None),    # G 12: two head groups of 8
    (2, 1000, 2, 2, 16, 777, None),    # hd 16: 256-slot tiles
    (2, 300, 2, 2, 256, 250, None),    # hd 256
])
@pytest.mark.parametrize("return_lse", [False, True])
def test_decode_kernel_edges_match_plain(cuda_device, dtype, b, c, kh, g, hd,
                                         valid, blocks, return_lse):
    """B4 at the edges of its split and tiles, one launch, against the
    plain version; dead slots hold +-1e9."""
    q = _randn((b, kh, g, hd), dtype, cuda_device, 14)
    k = _randn((b, c, kh, hd), dtype, cuda_device, 15)
    v = _randn((b, c, kh, hd), dtype, cuda_device, 16)
    k[:, valid:] = 1e9
    v[:, valid:] = -1e9
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    before = da.decode_attention_folded.launches
    got = da.decode_attention_folded(q, ks, vs, valid, blocks=blocks,
                                     return_lse=return_lse)
    torch.cuda.synchronize()
    assert da.decode_attention_folded.launches == before + 1
    want = da.decode_attention_plain(q, ks, vs, valid, return_lse=return_lse)
    tol = ATTN_TOL[dtype]
    if return_lse:
        (got, lse), (want, want_lse) = got, want
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_refuses_strides_tma_cannot_take(cuda_device, dtype):
    """A cache whose slot stride is not a multiple of 16 bytes (rows of 2
    kv heads of 64 and 2 elements of padding): TMA cannot address it, the
    wrapper raises before any launch."""
    q = _randn((1, 2, 2, 64), dtype, cuda_device, 17)
    k = torch.zeros((1, 40, 2 * 64 + 2), dtype=dtype,
                    device=cuda_device)[..., :128].unflatten(-1, (2, 64))
    before = da.decode_attention_folded.launches
    with pytest.raises(ValueError, match="aligned"):
        ops.decode_attention(q, k, k, 9)
    assert da.decode_attention_folded.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_decode_host_geometry_matches_the_library(cuda_device, dtype, hd):
    """The host's tiles (the CPU emulation's and ``work_split``'s) are the
    built kernel's, and every instance fits an SM at least once."""
    assert da.library_geometry(hd, dtype) == (*da.geometry(hd, dtype),
                                              da.CONSUMER_WARPS)
    for g in (1, 2, 3, 8):
        assert da._blocks_per_sm(hd, dtype, g) >= 1


@pytest.mark.cuda
def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 8, 1, 1, 32), device=cuda_device)
    k = torch.zeros((1, 8, 1, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, k)
    q = torch.zeros((1, 8, 1, 1, 16), device=cuda_device)
    k = torch.zeros((1, 8, 1, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, torch.zeros(8 * 16 + 1, device=cuda_device)
                            [1:].view(1, 8, 1, 16), k)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], k, k, 9)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), k)


@pytest.mark.cuda
def test_model_on_card_matches_plain_path(cuda_device):
    """Reduced qwen3 with a sliding window (ring caches), float32: prefill
    and 3 decode steps through B3/B4 on the card against the same weights
    on the CPU plain path; logits to 1e-4 (other summation orders), every
    layer through the kernels."""
    cfg = dataclasses.replace(get("qwen3-0.6b").reduced(), window=8)
    cpu = TransformerLM(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 15))
    f0, d0 = fa.flash_attention_folded.launches, \
        da.decode_attention_folded.launches
    outs = []
    for m in (card, cpu):
        lg, c = m.prefill({"tokens": toks[:, :12]}, cache_len=15)
        steps = [lg]
        for j in range(3):
            lg, c = m.decode_step(c, {"token": toks[:, 12 + j:13 + j],
                                      "pos": 12 + j})
            steps.append(lg)
        outs.append(torch.cat(steps, 1).cpu())
    assert fa.flash_attention_folded.launches - f0 == cfg.n_layers
    assert da.decode_attention_folded.launches - d0 == 3 * cfg.n_layers
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("gemma3-27b", {"n_layers": 7}),   # 3 groups and a tail, rings wrap
    ("mixtral-8x7b", {}), ("arctic-480b", {}), ("internvl2-2b", {}),
    ("whisper-medium", {}), ("qwen3-0.6b", {"kv_dtype": "int8"}),
    ("zamba2-7b", {"n_layers": 3, "kv_dtype": "int8"})])
def test_family_on_card_matches_plain_path(cuda_device, arch, kw):
    """Every family's reduced float32 model on ``request_batch``'s 40-long
    prompt (gemma3's past its 32-token window; internvl2's 8 vision
    embeddings and 32 tokens; whisper's 40 frames and 5 tokens) and 3
    decode steps through B3 / B4 on the card against the same weights on
    the CPU plain path: logits to 1e-4, one B3 per attention layer
    (encoder and decoder) and one B4 per decoder layer and step."""
    cfg = dataclasses.replace(get(arch).reduced(), **kw)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    batch = request_batch(cfg, 2, 40, np.random.default_rng(0))
    s0 = 40 if cfg.family != "encdec" else batch["tokens"].shape[1]
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 3))
    f0, d0 = fa.flash_attention_folded.launches, \
        da.decode_attention_folded.launches
    outs = []
    with torch.inference_mode():
        for m in (card, cpu):
            lg, c = m.prefill(batch, cache_len=s0 + 3)
            steps = [lg]
            for j in range(3):
                lg, c = m.decode_step(c, {"token": toks[:, j:j + 1],
                                          "pos": s0 + j})
                steps.append(lg)
            outs.append(torch.cat(steps, 1).cpu())
    if cfg.family == "encdec":
        n_b3, n_dec = cfg.enc_layers + cfg.dec_layers, cfg.dec_layers
    elif cfg.family == "hybrid":
        n_b3 = n_dec = cfg.n_layers // cfg.hybrid_attn_every
    else:
        n_b3 = n_dec = cfg.n_layers
    assert fa.flash_attention_folded.launches - f0 == n_b3
    assert da.decode_attention_folded.launches - d0 == 3 * n_dec
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


@pytest.fixture
def nccl_mesh(cuda_device):
    """An ``nccl`` world of one and its ``(data 1, model 1)`` mesh, torn
    down after the test (unless a world already existed)."""
    import torch.distributed as dist

    from repro_torch.runtime import elastic_mesh
    started = not dist.is_initialized()
    mesh = elastic_mesh(model=1)
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b", "mixtral-8x7b",
                                  "internvl2-2b", "whisper-medium",
                                  "mamba2-2.7b", "zamba2-7b"])
def test_family_on_a_mesh_of_one_equals_meshless_on_card(nccl_mesh, arch):
    """Every family built on a ``(1, 1)`` mesh (``build_model(mesh=)``)
    and seeded alike serves bit for bit as the meshless model on the card,
    with the same B3 / B4 / B5 launches: a model axis of 1 issues no
    collective and takes every slice whole."""
    cfg = get(arch).reduced()
    dev = torch.device("cuda")
    batch = request_batch(cfg, 2, 40, np.random.default_rng(0))
    s0 = 40 if cfg.family != "encdec" else batch["tokens"].shape[1]
    outs, counts = [], []
    for mesh in (None, nccl_mesh):
        m = build_model(cfg, device=dev, mesh=mesh).init(
            torch.Generator(device=dev).manual_seed(0))
        before = (fa.flash_attention_folded.launches,
                  da.decode_attention_folded.launches,
                  ssd_scan.ssd_intra_folded.launches)
        with torch.inference_mode():
            lg, c = m.prefill(batch, cache_len=s0 + 3)
            steps = [lg]
            for j in range(3):
                tok = steps[-1][:, -1].argmax(-1)[:, None]
                lg, c = m.decode_step(c, {"token": tok, "pos": s0 + j})
                steps.append(lg)
        outs.append(torch.cat(steps, 1).cpu())
        counts.append((fa.flash_attention_folded.launches - before[0],
                       da.decode_attention_folded.launches - before[1],
                       ssd_scan.ssd_intra_folded.launches - before[2]))
    assert torch.equal(outs[0], outs[1]) and counts[0] == counts[1]


def _ssd_inputs(shape, device, seed):
    bc, q, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bc, q, h, p)).astype(np.float32)
    cum = np.cumsum(-np.abs(rng.standard_normal((bc, q, h))) * 0.1,
                    axis=1).astype(np.float32)
    B, C = (rng.standard_normal((bc, q, n)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(device) for a in (x, cum, B, C)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 16, 1, 8, 4), (2, 64, 2, 32, 16), (6, 37, 1, 16, 8),
    (1, 128, 4, 64, 128),              # the reference's sweep
    (3, 17, 5, 128, 64),               # a short chunk, the widest head
    (64, 256, 80, 64, 128),            # mamba2-2.7b's serving shape
    # the wgmma route (P 64, N 64 or 128)
    (64, 256, 112, 64, 64),            # zamba2-7b's serving shape
    (3, 232, 5, 64, 128),              # ragged chunks
    (5, 17, 3, 64, 64), (6, 37, 4, 64, 128),
    (2, 256, 17, 64, 64),              # groups of 9 and 8 heads
    (4, 256, 1, 64, 128),              # one head
    (2, 200, 3, 64, 32),               # N 32 keeps the mma route
])
def test_ssd_kernel_matches_plain_on_card(cuda_device, shape):
    """B5, one launch, against ``ssd_intra_plain`` on the same CUDA
    tensors: every element within 1e-4 + 1e-4 |plain| (the reference
    test's tolerance)."""
    args = _ssd_inputs(shape, cuda_device, sum(shape))
    before = ssd_scan.ssd_intra_folded.launches
    got = ssd_scan.ssd_intra_folded(*args)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_intra_folded.launches == before + 1
    want = ssd_scan.ssd_intra_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (8, 256, 80, 64, 128),             # mamba2-2.7b's heads and state
    (8, 256, 112, 64, 64),             # zamba2-7b's
    (4, 232, 80, 64, 128),             # a ragged last chunk
    (4, 200, 112, 64, 64),
])
def test_ssd_kernel_at_the_model_widths_with_column_slices(cuda_device,
                                                           shape):
    """B5 at the served models' head counts and states, full and ragged
    chunks, B and C read as column slices of one fused row (as the model's
    xBC projection hands them over): within 1e-4 + 1e-4 |plain|."""
    x, cum, B, C = _ssd_inputs(shape, cuda_device, shape[1] + shape[2])
    n = B.shape[-1]
    wide = torch.cat([B[..., :12], B, C], -1)
    Bs, Cs = wide[..., 12:12 + n], wide[..., 12 + n:]
    assert Bs.stride(-2) == 2 * n + 12
    got = ssd_scan.ssd_intra_folded(x, cum, Bs, Cs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ssd_scan.ssd_intra_plain(x, cum, B, C),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 100, 3, 16, 8), (2, 100, 3, 64, 128),
                                   (2, 256, 4, 64, 64)])
def test_ssd_kernel_reads_column_slices_and_skips_the_upper_triangle(
        cuda_device, shape):
    """B and C as column slices of one wider tensor; a log-decay so steep
    that exp(cum_i - cum_j) overflows above the diagonal: nothing is NaN
    (both routes)."""
    bc, q, h, _, n = shape
    x, _, B, C = _ssd_inputs(shape, cuda_device, 1)
    cum = torch.linspace(0.0, -500.0, q, device=cuda_device)[
        None, :, None].expand(bc, q, h).contiguous()
    wide = torch.cat([B[..., :4], B, C], -1)
    got = ssd_scan.ssd_intra_folded(x, cum, wide[..., 4:4 + n],
                                    wide[..., 4 + n:])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ssd_scan.ssd_intra_plain(x, cum, B, C),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [
    dict(heads=4), dict(heads=1), dict(window=1), dict(window=64),
    dict(blocks=1), dict(blocks=7, window=3, heads=5), dict(draw=False),
    dict(draw=False, blocks=5, heads=3)])
def test_ssd_wgmma_schedules_agree_bit_for_bit(cuda_device, schedule):
    """The wgmma route's head groups, windows, grid and walk of the work
    list change only who computes which item, in what order: the output is
    bit for bit the default's, before and after."""
    args = _ssd_inputs((6, 232, 10, 64, 128), cuda_device, 3)
    want = ssd_scan.ssd_intra_folded(*args)
    got = ssd_scan._launch(*args, schedule)
    again = ssd_scan.ssd_intra_folded(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.cuda
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, cum, B, C = _ssd_inputs((1, 16, 2, 8, 4), cuda_device, 0)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_intra_folded(x.bfloat16(), cum, B, C)
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan.ssd_intra_folded(x, cum, torch.zeros(
            1 + B.numel(), device=cuda_device)[1:].view(B.shape), C)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan.ssd_intra_folded(x[..., :6], cum, B, C)
    big = _ssd_inputs((1, 257, 1, 8, 4), cuda_device, 0)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_intra_folded(*big)
    with pytest.raises(ValueError):
        ssd_scan.ssd_intra_folded(x, cum.cpu(), B, C)
    with pytest.raises(ValueError, match="heads"):
        ssd_scan._launch(x, cum, B, C, dict(heads=17))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers,launches", [
    ("mamba2-2.7b", 2, (0, 0, 2)),     # B3, B4 (3 steps), B5 per run
    ("zamba2-7b", 3, (1, 3, 3)),       # one group of 2 and a tail of 1
])
def test_ssm_models_on_card_match_plain_path(cuda_device, arch, layers,
                                             launches):
    """Reduced float32 MambaLM and Zamba2LM: a 21-token prefill (a ragged
    last chunk) and 3 decode steps through the kernels on the card against
    the same weights on the CPU plain path; logits to 1e-4."""
    cfg = dataclasses.replace(get(arch).reduced(), n_layers=layers)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    counters = (fa.flash_attention_folded, da.decode_attention_folded,
                ssd_scan.ssd_intra_folded)
    start = [c.launches for c in counters]
    outs = []
    with torch.inference_mode():
        for m in (card, cpu):
            lg, c = m.prefill({"tokens": toks[:, :21]}, cache_len=24)
            steps = [lg]
            for j in range(3):
                lg, c = m.decode_step(c, {"token": toks[:, 21 + j:22 + j],
                                          "pos": 21 + j})
                steps.append(lg)
            outs.append(torch.cat(steps, 1).cpu())
    assert tuple(c.launches - s for c, s in zip(counters, start)) == launches
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the comparators and the re-planner: the same injected draws on the card
# (B1, B2) and on the CPU (their plain versions) give the same solves
# ---------------------------------------------------------------------------

def _deadlined(net, ratio, n_devices):
    env = paper_environment()
    dag = merge_dags([zoo.build(net, pin_server=d) for d in range(n_devices)])
    h, _ = heft_makespan(dag, env)
    return dag.with_deadline(np.full(dag.num_apps, ratio * h)), env


def _swarm_draws(P, seed=7):
    """``draw_fn(i, step)`` of PSO-GA's step draws, from numpy."""
    def draw(i, step, p=None, s=None):
        u = np.random.default_rng([seed, i, step]).random((P, 9),
                                                          dtype=np.float32)
        return draws_from_uniforms(torch.as_tensor(u), torch.tensor(p),
                                   torch.tensor(s))
    return draw


def _same(a, b):
    np.testing.assert_array_equal(a.best_x, b.best_x)
    assert (a.iterations, a.feasible, a.best_fitness, a.best_cost) == \
        (b.iterations, b.feasible, b.best_fitness, b.best_cost)


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", [False, True])
def test_ga_on_card_equals_cpu(cuda_device, traffic):
    """``run_ga`` with the same injected population and draws on the card
    and on the CPU: the same solve; B1 (or B2) launched every generation."""
    dag, env = _deadlined("googlenet", 3.0, 2)
    prob = SimProblem.build(dag, env)
    cfg = GAConfig(pop_size=100, max_iters=60, stall_iters=20)
    P, T, p, S = cfg.pop_size, cfg.tournament, prob.num_layers, \
        prob.num_servers
    X0 = np.random.default_rng(1).integers(0, S, (P, p)).astype(np.int32)

    def draw(gen):
        r = np.random.default_rng([3, gen])
        return GADraws(cand=r.integers(0, P, (P, 2, T)).astype(np.int32),
                       do_x=r.random(P, dtype=np.float32),
                       seg=r.integers(0, p, (P, 2)).astype(np.int32),
                       mu=r.random((P, p), dtype=np.float32),
                       vals=r.integers(0, S, (P, p)).astype(np.int32))
    arr = TrafficConfig(kind="bursty", rate=0.5).solver_arrivals(
        2, seed=1) if traffic else None
    b1, b2 = schedule_sim.schedule_replay, traffic_sim.traffic_replay
    start = (b1.launches, b2.launches)
    card = run_ga(dag, env, cfg, device=cuda_device, X0=X0, draw_fn=draw,
                  arrivals=arr)
    n1, n2 = b1.launches - start[0], b2.launches - start[1]
    cpu = run_ga(dag, env, cfg, device="cpu", X0=X0, draw_fn=draw,
                 arrivals=arr)
    _same(card, cpu)
    # the first scoring and one per generation run; then the epilogue's B1
    fit_launches = n2 if traffic else n1 - 1
    assert card.iterations + 1 <= fit_launches \
        <= card.iterations + SYNC_EVERY
    assert n1 >= 1 and (n2 > 0) == traffic


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pso_linear", "pre_pso"])
def test_pso_linear_and_pre_pso_on_card_equal_cpu(cuda_device, solver):
    """The same injected swarm and step draws on the card and on the CPU:
    the same solve, with one B1 launch per step besides the first scoring
    and the epilogue."""
    dag, env = _deadlined("googlenet", 2.0, 1)
    solved = preprocess(dag)[0] if solver == "pre_pso" else dag
    prob = SimProblem.build(solved, env)
    cfg = PSOGAConfig(pop_size=64, max_iters=80, stall_iters=20)
    X0 = init_swarm(prob, cfg, torch.Generator().manual_seed(0),
                    device="cpu").numpy()
    base = _swarm_draws(cfg.pop_size)

    def draw(i, step):
        return base(i, step, prob.num_layers, prob.num_servers)
    fn = run_pso_linear if solver == "pso_linear" else pre_pso
    b1 = schedule_sim.schedule_replay
    start = b1.launches
    card = fn(dag, env, cfg, device=cuda_device, X0=X0, draw_fn=draw)
    n1 = b1.launches - start
    _same(card, fn(dag, env, cfg, device="cpu", X0=X0, draw_fn=draw))
    assert card.iterations + 2 <= n1 <= card.iterations + 2 + SYNC_EVERY


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", [False, True])
def test_replan_round_on_card_equals_cpu(cuda_device, traffic):
    """One node-loss round with the same injected warm swarms and draws on
    the card and on the CPU: the same decisions and plans; the round
    launched B1 (and, under traffic, B2)."""
    env = paper_environment()
    dags = [_deadlined(net, 1.5, 1)[0] for net in ("alexnet", "googlenet")]
    trace = sample_trace("node-loss", env, rounds=2, seed=1)
    probs = [SimProblem.build(d, trace.env_at(1)) for d in dags]
    incs = [greedy_offload(d, env).best_x for d in dags]
    cfg = ReplanConfig(pso=PSOGAConfig(pop_size=48, max_iters=60,
                                       stall_iters=15),
                       migration_weight=0.1)
    X0 = [init_swarm(pr, cfg.pso, torch.Generator().manual_seed(i),
                     device="cpu", incumbent=inc).numpy()
          for i, (pr, inc) in enumerate(zip(probs, incs))]
    base = _swarm_draws(cfg.pso.pop_size, seed=11)

    def draw(i, step):
        return base(i, step, probs[i].num_layers, probs[i].num_servers)
    arr = [TrafficConfig(kind="bursty", rate=0.5).solver_arrivals(
        1, seed=31 * i) for i in range(2)] if traffic else None
    b1, b2 = schedule_sim.schedule_replay, traffic_sim.traffic_replay
    start = (b1.launches, b2.launches)
    card = replan_round(probs, incs, cfg, seed=2, arrivals=arr,
                        device=cuda_device, X0=X0, draw_fn=draw)
    n1, n2 = b1.launches - start[0], b2.launches - start[1]
    cpu = replan_round(probs, incs, cfg, seed=2, arrivals=arr, device="cpu",
                       X0=X0, draw_fn=draw)
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
    for field in card[1]._fields:
        if field != "wall_s":
            np.testing.assert_array_equal(getattr(card[1], field),
                                          getattr(cpu[1], field),
                                          err_msg=field)
    assert n1 > 0 and (n2 > 0) == traffic


@pytest.mark.cuda
def test_replay_wrapper_is_safe_under_threads(cuda_device):
    """``run_services`` replays from several threads: two threads × 50 B1
    calls at once on different problems (each call with its own swarm)
    give, call for call, the single-thread results bit for bit, and the
    launch counter counts exactly 100."""
    buckets = [_fleet(cuda_device, max_apps=3), _deep_bucket(cuda_device)]
    rng = np.random.default_rng(17)
    swarms = []
    for probs, ppb in buckets:
        N, max_p = ppb.pinned.shape
        Xs = []
        for _ in range(50):
            X = np.zeros((N, 96, max_p), np.int32)
            for n, pr in enumerate(probs):
                X[n, :, :pr.num_layers] = rng.integers(
                    0, pr.num_servers, size=(96, pr.num_layers))
                X[n, :, 0] = np.where(pr.pinned[0] >= 0, pr.pinned[0], 0)
            Xs.append(torch.as_tensor(X, device=cuda_device))
        swarms.append(Xs)
    b1 = schedule_sim.schedule_replay
    got = [[None] * 50, [None] * 50]
    errors = []

    def work(t):
        try:
            args = kernel_args(buckets[t][1])
            for c, X in enumerate(swarms[t]):
                got[t][c] = b1(*args, X, faithful=bool(t))
            torch.cuda.synchronize()
        except Exception as e:            # reported by the assert below
            errors.append(e)

    switch = sys.getswitchinterval()
    start = b1.launches
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads) and errors == []
    assert b1.launches - start == 100
    for t, (_, ppb) in enumerate(buckets):
        args = kernel_args(ppb)
        for c, X in enumerate(swarms[t]):
            want = b1(*args, X, faithful=bool(t))
            for a, b in zip(got[t][c], want):
                assert torch.equal(a, b), (t, c)


# ---------------------------------------------------------------------------
# training: the differentiable route, never the kernels
# ---------------------------------------------------------------------------

def _launch_counts():
    return (fa.flash_attention_folded.launches,
            da.decode_attention_folded.launches,
            ssd_scan.ssd_intra_folded.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b", "mixtral-8x7b",
                                  "mamba2-2.7b", "zamba2-7b",
                                  "internvl2-2b", "whisper-medium"])
def test_train_step_on_card_equals_cpu(cuda_device, arch):
    """A reduced float32 model from the same weights and batch: every
    gradient of ``loss_fn`` within 1e-4 (relative norm) of the CPU's, then
    one train step's loss, gradient norm and learning rate to 1e-5
    (float32 sums in other orders, TF32 off); no kernel launched. (The
    updated parameters are not compared: Adam's first step moves each by
    about ±lr, the sign of a gradient entry near zero.)"""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_stream
    from repro_torch.launch.steps import make_train_objects
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get(arch).reduced()
    shape = ShapeSpec("t", 32, 2, "train")
    acfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    batch = make_stream(cfg, shape).batch(0)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out, init = {}, None
        for dev in (torch.device("cpu"), cuda_device):
            model, step, _ = make_train_objects(cfg, shape, acfg, device=dev)
            if init is None:
                model.init(torch.Generator().manual_seed(0))
                init = {n: t.clone() for n, t in model.state_dict().items()}
            else:
                model.load_state_dict(init)
            before = _launch_counts()
            model.loss_fn(batch)[0].backward()
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            _, m = step(adamw_init(dict(model.named_parameters())), batch)
            assert _launch_counts() == before
            out[dev.type] = ({k: float(v) for k, v in m.items()}, grads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (mc, gc), (mh, gh) = out["cuda"], out["cpu"]
    for k in mh:
        assert abs(mc[k] - mh[k]) <= 1e-5 * abs(mh[k]), (k, mc, mh)
    for name, g in gh.items():
        assert bool(torch.isfinite(gc[name]).all()), name
        assert float((gc[name] - g).norm()) <= 1e-4 * float(g.norm()), name


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(cuda_device):
    """B3, B4 and B5 have no backward: an input that requires grad is
    refused in grad mode, before any launch; under no_grad they run."""
    q = torch.randn(2, 2, 64, 16, device=cuda_device, requires_grad=True)
    k = torch.randn(2, 64, 16, device=cuda_device)
    xc = torch.randn(2, 16, 2, 16, device=cuda_device, requires_grad=True)
    cum = torch.zeros(2, 16, 2, device=cuda_device)
    B = torch.randn(2, 16, 16, device=cuda_device)
    calls = [lambda: fa.flash_attention_folded(q, k, k, causal=True,
                                               window=0),
             lambda: da.decode_attention_folded(q[:, :, 0], k, k, 5),
             lambda: ssd_scan.ssd_intra_folded(xc, cum, B, B)]
    before = _launch_counts()
    for call in calls:
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    assert _launch_counts() == before
    with torch.no_grad():
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert _launch_counts() == tuple(n + 1 for n in before)
