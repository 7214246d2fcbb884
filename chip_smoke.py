#!/usr/bin/env python3
"""Drive the PyTorch port's planner, LM servers (every model family) and
trainer on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero with no
result line):

  1. build   — compile every CUDA kernel of ``_build.SOURCES`` (every
               ``src/repro_torch/kernels/csrc/*.cu``) with nvcc, one process
               per source, all started together; B3's wgmma kernel at head_dim
               64, 112, 128 and 256: ptxas's registers and spills (none
               allowed) and its dynamic shared memory; every instance of B4's
               ``decode_tma_kernel`` (2 dtypes x 5 head_dims x 4 head-group
               sizes) and of its ``decode_merge_kernel``: registers and
               spills (none allowed), and B4's host tiles against the
               library's; every instance of B5 (``ssd_wgmma_kernel``,
               ``ssd_mma_kernel`` at column tiles 16, 32, 64): registers
               and spills (none allowed), no wgmma serialized by ptxas, the
               wgmma kernel's dynamic shared memory, and B5's host routes
               against the library's;
  2. check   — each kernel against its plain PyTorch version on CUDA
               tensors, for seeded random swarms. B1 (zero-load replay):
               resnet101 on the paper fleet (both fidelity modes), the
               paper's Fig. 8 problem (30 resnet101 copies, 10,140
               layers), one fleet bucket of 8 zoo DNNs, a bucket whose
               parents reach beyond the walk's ring of end times (both
               modes, 129 particles); ``feasible`` exact, costs rtol 1e-5. B2 (traffic replay), both modes:
               the qwen3-0.6b traffic bucket, an alexnet + googlenet fleet
               bucket under each of the four arrival families (one app
               with no request at all) and under arrivals tied across its
               apps, resnet101, and the deep bucket under bursty draws
               (parent reads beyond B2's ring asserted); ``static_ok`` and
               miss rates exact, costs, latency sums and latencies rtol
               1e-5, bit equality printed;
  3. time    — each kernel and its plain version: B1 at the qwen3-0.6b
               plan bucket and the Fig. 8 shape (calls queued behind a device
               sleep, five rounds, medians), beside its bytes bound and the
               chain bound of its walk; B2 the same way at the qwen3-0.6b
               traffic bucket and at resnet101 (chain bound: the longest
               lane's steps);
  4. plan    — the main path: ``plan_offload_batch`` for qwen3-0.6b's
               serving shapes, as ``python -m repro_torch.launch.plan``;
  5. traffic — the same plan under bursty traffic (``--traffic bursty``):
               every key replays through the plain traffic replay, B2 is
               held against its plain version at the solve's own buckets
               and draws and at each held-out replay, and each plan's
               held-out miss tails are printed;
  6. fig8    — ``run_pso_ga`` on the Fig. 8 problem at the paper's
               settings, no worse than ``greedy_offload``'s plan;
  7. traffic-fleet — alexnet + googlenet at the paper's settings, solved
               zero-load and traffic-aware under bursty and flash-crowd
               traffic: B2 is held against its plain version at the
               solves' own buckets and draws and at every held-out replay,
               and the traffic-aware plan's held-out p95 miss rate is no
               worse than the zero-load plan's;
  8. baselines — the paper's comparators on the Fig. 8 problem: ``run_ga``
               (pop 100, <= 1000 generations, stall 50), ``run_pso_linear``
               and ``pre_pso`` (the paper's PSO settings), each plan replayed
               by ``simulate_np`` and its B1 launches held to its iterations;
               B1 against its plain version on a swarm holding the three
               plans; then ``run_ga`` under bursty 0.5/s traffic on the
               traffic-fleet problems (B2; the key against the plain traffic
               replay, B2 against its plain version at the GA's shape);
  9. replan  — ``replan_fleet`` on qwen3-0.6b's three planned serving
               shapes: a zero-drift round keeps every plan bit for bit;
               4-round congestion and node-loss traces (B1), then load-surge
               under bursty traffic (B2); per round the plans changed, fleet
               cost, moved layers, wall and launches; accepted plans strictly
               beat their incumbents and avoid churned servers, final plans
               replay through ``simulate_np``, and B1 (B2) hold against their
               plain versions at the last round's buckets;
 10. service — the always-on planning service (``run_service``) on the
               plan and traffic phases' qwen3-0.6b results, each round's
               rungs, wall and B1 / B2 launches printed: (a) a 6-round
               congestion trace under ``--chaos``'s faults (crash at round
               2, NaN env at 3, server 1 down mid-round at 4) with the plan
               cache — every served plan passes ``_plan_ok`` on the env it
               runs on, one stale env, a crash or retry, B1 launched in
               every solved round; (b) a zero-drift trace with the plan
               cache — later rounds are cache hits, no launch, the cold
               plans bit for bit; (c) ``--serve bursty`` (load-surge) with
               rates estimated from queued observations, ingestion threads
               0 and 2 — B2 launched, enqueued + dropped = offered; (d)
               ``run_services`` of two services on threads sharing one
               cache and one telemetry — each equals its solo run, the
               trace passes ``scripts/check_trace.py``; (e) walls with
               telemetry off / on / on / off (plans equal), then one
               profiled run (device busy, idle share);
 10b. mesh  — every solve sharded over a device mesh (``launch.mesh``):
               (a) ``resolve_mesh("host")``, an ``nccl`` world of one over
               the card: qwen3-0.6b's plan and traffic plan, the Fig. 8
               solve, one congestion replan round and a 3-round
               congestion service under ``--chaos``, each bit for bit its
               ``--mesh none`` run with equal B1 / B2 launches, walls
               printed; (b) two processes (``chip_smoke.py --mesh-rank``)
               sharing ``cuda:0`` over ``gloo`` with
               ``elastic_mesh(model=1)``: the plan's 3-problem bucket
               padded to 4 rows and the traffic plan, bit for bit the plan
               and traffic phases' results on both ranks, each rank's
               launches printed;
 11. check-attn — B3 (flash prefill) and B4 (flash decode) against their
               plain versions on CUDA tensors, float32 to 2e-5 and bfloat16
               to 2e-2: qwen3-0.6b's serving shapes (batch 8, prompt 2048,
               cache 2080; causal and a 512 window; valid_len 1, 7, 1000,
               2048, 2080), zamba2-7b's (32 q and 32 kv heads of head_dim
               112; valid_len 1, 2049, 2079), windows whose first kv tile is
               wholly masked for some rows, and ragged shapes of the CPU sweep (head_dim 16 to 256, 112
               among them); new in the serving families' slice: gemma3-27b's
               local layers (batch 8, prompt 2048, 16 kv heads of 2 query
               heads, head_dim 128, window 1024), whisper-medium's encoder
               (bidirectional, 1500 frames, 16 heads of 64) and decoder
               (causal, 187 tokens), B4 over gemma3's full 1024-slot ring and
               whisper's 1532-slot self cache (valid 1501, 1532); B4's
               log-sum-exp output (``return_lse``) against the plain
               version's ``torch.logsumexp`` to 2e-5 at a rank's slice of
               the batch-1 caches (qwen3's 1,040 of 2,080 slots with valid
               1, 1000 and 1040, zamba2's, half of gemma3's ring, qwen3's 1 x
               8,200 slice of four cards); every B4 case with and without
               ``return_lse``, and B4's edges: one row over many blocks,
               ranges that cross rows (a forced grid), valid inside the first
               tile, G 8 and 12, head_dim 16 and 256; the edges
               of B3's 128-row tiles: seq 1 and 17, 256 (whole tiles), 129
               (hd 64 bidirectional, hd 112 causal), a window of 7 and G 3
               and 4 at hd 128; new with the last two dense models: B3 and B4
               at gemma-7b's serving shapes (16 heads of 256; cache 2080,
               valid 2048) and starcoder2-3b's (2 kv heads of 12 query heads
               of 128), B3's head_dim-256 edges (one token, seq 129, a window
               of 100);
 12. serve   — the LM main path: ``repro_torch.launch.serve.Server`` with
               qwen3-0.6b at full width and depth (28 layers, bfloat16,
               seeded weights on the card), batch 8, prompt 2048, 32 new
               tokens, no EOS; a first call, then a counted one that must
               launch B3 28 times and B4 28 x 31 times and give the same
               tokens; prints prefill ms and decode tokens/s;
 13. serve-check — qwen3-0.6b at full width, 2 layers: prefill of 1000
               tokens and 4 greedy decode steps through the kernels against
               the same tokens through the plain versions on the card; in
               float32 (the CUDA-core B3 route) logits to 1e-4, equal tokens,
               and decode logits against the prefill logits of the longer
               prompt (teacher-forced, 2e-3); in bfloat16 (the tensor-core B3
               route) logits to 2e-2 + 2e-2 |plain|, token equality printed;
 13b. serve-mesh — the server on a device mesh (tensor parallelism, ROADMAP
               item 13b): (a) ``Server(mesh=elastic_mesh(model=1))``, an
               ``nccl`` world of one, qwen3-0.6b at full width and depth in
               bfloat16 (batch 8 x 2048, 32 new), in turns with the meshless
               Server (none, mesh, mesh, none): tokens bit for bit, 28 B3 +
               868 B4 each call; (b) two processes (``chip_smoke.py
               --serve-rank``) sharing ``cuda:0`` over ``gloo`` on
               ``elastic_mesh(model=2)`` = ``(data 1, model 2)``: the same
               qwen3 on each rank's half of the heads (28 B3 at 8 q / 4 kv
               heads, 868 B4 at 4 kv heads, the heads recorded at the
               kernels' layout wrappers), prefill ms, decode tokens/s and
               peak memory a rank, tokens against the world of one's
               (printed); float32 at full width, batch 2 x 1000 and 4 greedy
               steps, qwen3 (2 layers), mamba2 (2 blocks, B5 at 40 heads a
               rank) and mixtral (2 layers, 4 experts a rank) against the
               meshless runs on the card (logits 1e-4, tokens equal) and
               against the plain kernels on each rank (1e-4); qwen3 on
               ``(data 2, model 1)``, a row a rank, against the meshless run;
 14. time-attn — B3 and B4 per launch at qwen3-0.6b's and zamba2-7b's
               serving shapes (CUDA events over calls queued behind a device
               sleep, five rounds in turns with one
               ``scaled_dot_product_attention`` call as the yardstick,
               medians), beside their plain versions and bounds (B3 also at
               the tensor-core FLOPs its wgmma route issues: whole tiles,
               P.V for the weights' hi and lo parts); also B3 at
               gemma3-27b's local shape (window 1024, SDPA with a boolean band
               mask) and whisper-medium's encoder (bidirectional, SDPA with
               ``is_causal=False``), and B4 over gemma3's 1024-slot ring and
               qwen3's 1 x 8,200 rank slice (every slot live); beside each B4
               shape a read ceiling (``torch.sum`` in float32 over the same
               live K and V, in the same turns), a cold figure (calls
               rotating over copies of the cache that exceed 4 x the 50 MB
               L2) and B4's time by grid size (``blocks=``, the chosen
               default printed); B4 with and without ``return_lse`` in turns
               at qwen3's serving cache and at a rank's batch-1 slice; B3
               and B4 at gemma-7b's and starcoder2-3b's serving shapes;
 15. check-ssd — B5 (the SSD intra-chunk form) against its plain version
               on CUDA tensors, every element within 1e-4 + 1e-4 |plain|:
               the reference's sweep shapes, chunks of 17 and 37 rows,
               mamba2-2.7b's serving shape (64 chunks of 256, 80 heads of 64,
               state 128) and zamba2-7b's (112 heads, state 64), B and C as
               column slices, the inputs of a real full-width ``mamba_seq``
               prefill, a log-decay steep enough that exp overflows above the
               diagonal (both routes), the wgmma route's edges (ragged
               chunks of 232, 17, 37 and 199 rows, 17 heads in groups of 9
               and 8, one head, B and C sliced 20 columns in), three other
               schedules (the static walk among them) bit for bit the
               default's, and causality (future
               inputs leave past rows equal); each line names its route;
 16. serve-ssm — ``Server`` with mamba2-2.7b at full width and depth (64
               layers, bfloat16, seeded weights on the card), batch 8,
               prompt 2048, 32 new tokens, no EOS; the counted call must
               launch B5 64 times and B3 and B4 never, and give the first
               call's tokens; prints prefill ms, decode tokens/s, peak memory;
 17. serve-hybrid — the same with zamba2-7b (81 Mamba2 blocks, 13 shared
               attention sites): B5 81 times, B3 13 and B4 13 x 31 times;
 18. serve-check-ssm — mamba2-2.7b at full width with 2 layers and
               zamba2-7b with 7 (one group and one tail block), float32:
               prefill of 1000 tokens (a ragged last chunk) and 4 greedy
               steps through the kernels and through the plain versions on
               the card (logits to 1e-4, equal tokens), and decode logits
               against the prefill of the longer prompt (2e-3);
 19. time-ssd — B5 per launch at mamba2-2.7b's and zamba2-7b's serving
               shapes, timed as in 14 (no single PyTorch call computes it, so
               no library yardstick), in turns with the mma.sync route (the
               earlier kernel) and with the wgmma route's static walk of
               its work list (no counter) at the same shape, beside its
               plain version,
               the bound of its 3xTF32 tensor-core route and the float32
               CUDA-core bound; its route and TFLOP/s of issued 3xTF32 work
               (whole tiles); the wgmma route's schedule swept (heads a work
               item x chunks a window) with the default's place in it;
 20. serve-families — ``Server`` with every other family at full width,
               bfloat16, seeded weights, batch 8, 32 new tokens, no EOS, a
               first call then a counted one (same tokens, launches exact),
               prefill ms, decode tokens/s and peak memory per model, each
               model freed before the next: gemma3-27b (62 layers, prompt
               2048: 62 B3, 1922 B4), arctic-480b cut to 2 of 35 layers
               (capacity 320; 2 B3, 62 B4), internvl2-2b (24 layers, 1024
               vision embeddings + 1024 tokens; 24 B3, 744 B4),
               whisper-medium (24 + 24 layers, 1500 frames, 187 decoder
               tokens; 48 B3, 744 B4, cross attention plain), qwen3-0.6b
               with the int8 KV cache (28 B3, 868 B4), gemma-7b (28
               layers, 16 heads of 256, geglu, vocab 256,000: 28 B3, 868
               B4), starcoder2-3b (30 layers, 24 q / 2 kv heads of 128: 30
               B3, 930 B4) and, last, kept for
               moe-a2a, mixtral-8x7b cut to 16 of 32 layers (prompt 2048,
               16,384 tokens: capacity 5120 an expert; 16 B3, 496 B4);
 20b. moe-a2a — mixtral with ``moe_impl="a2a"`` (experts dispatched by
               ``all_to_all_single`` over the world-of-one mesh), built by
               ``make_prefill_objects`` / ``make_decode_objects`` on
               ``meta`` and given serve-families' 16-layer bf16 weights
               (no second copy): batch 8 x 2048 (past 8,192 tokens, so
               entries can drop), 31 decode steps, scatter's tokens, 16 B3
               + 496 B4, prefill ms, decode tokens/s and peak memory
               printed; then 2 layers in float32 at full width, batch 2 x
               1000 and 4 greedy steps: logits and tokens bit for bit
               scatter's;
 21. serve-check-families — the kernels against the plain path inside each
               new family, as in 13: float32 at full width gemma3 with 7
               layers (one group, one tail layer; batch 2, prompt 1300, past
               the window), mixtral with 2 layers, internvl2 with 2 layers
               (1024 vision + 276 tokens), whisper with 2 + 2 layers (1500
               frames), qwen3 with 2 layers and the int8 cache (no
               teacher-forced check: the prefill attends unquantized keys),
               gemma-7b and starcoder2-3b with 2 layers (batch 2, prompt
               1000); bfloat16 arctic with 1 layer and gemma-7b with 2 (the
               head_dim-256 wgmma B3);
 22. train-check — the training route (``loss_fn`` and its backward) on
               the card against the same route on the CPU, float32 at full
               width from the same seeded weights and data-stream batch:
               qwen3-0.6b (2 layers) and mamba2-2.7b (2 blocks) at batch 2
               x 256, whisper-medium (2 + 2 layers) at 1,500 frames; every
               gradient finite and within 1e-4 (relative norm) of the
               CPU's, the loss within 1e-5, no kernel launched;
 23. train   — qwen3-0.6b at full width and depth (28 layers, bfloat16)
               through ``Trainer`` as ``python -m repro_torch.launch.train
               --steps 8 --batch 4 --seq 4096`` runs it, checkpoints every
               4 steps and a failure injected before step 6: the loss falls,
               the step-4 checkpoint restores the parameters and moments
               bit for bit and step 5 re-runs to the same loss bit for bit,
               no kernel launched; step ms, tokens/s, 6·N·tokens / step
               time / 989 TFLOP/s and peak memory printed;
 24. train-mesh — the ``Trainer`` on a device mesh: (a) on the ``nccl``
               world of one, qwen3-0.6b in bfloat16 at full width and depth,
               batch 4 x 4,096, 4 steps, ``Trainer(mesh=elastic_mesh(
               model=1))`` bit for bit the meshless ``Trainer`` (losses,
               norms, final parameters); (b) two processes
               (``chip_smoke.py --train-rank``) sharing ``cuda:0`` over
               ``gloo``: float32 2-layer qwen3 at full width on ``(2, 1)``
               and ``(1, 2)`` and 1-layer mixtral on ``(1, 2)``, batch 4 x
               256, 4 steps, losses within 1e-4 of the meshless runs, ranks
               equal, each rank's ZeRO-1 moments 1/data of its parameters'
               elements, no kernel launched; qwen3's run on ``(2, 1)``
               crashes before step 3, and its step-2 whole-tensor
               checkpoint restored on ``(1, 2)`` lands on the
               uninterrupted run's final loss; mixtral's final state
               checkpointed, the device memory the save adds printed and
               held under two of its largest whole leaf;
 25. seq-decode — batch-1 sequence-parallel decode on two processes
               (``--seq-rank``) sharing ``cuda:0`` over ``gloo``, ``(data 2,
               model 1)``, prompt 2,048, 32 new tokens: qwen3-0.6b bfloat16
               at full depth through ``Server``, each rank 28 B3 and 868 B4
               over its 1,040 of 2,080 slots (launches, slots, prefill ms,
               decode tokens/s and peak memory a rank printed; tokens
               against the meshless server's printed); float32 2-layer
               qwen3, 2-layer gemma3 (local rings of 1,024, 512 a rank),
               7-layer zamba2 and 2 + 2-layer whisper against the meshless
               batch-1 runs (logits 1e-4, tokens equal), ranks bit for bit;
 26. dryrun  — the dry run and its counter (``launch.dryrun``,
               ``launch.analysis.trace_step``): (a) ``python -m
               repro_torch.launch.dryrun`` for qwen3-0.6b ``train_4k`` and
               ``decode_32k`` on 256 fake ranks and mixtral-8x7b
               ``prefill_32k --multi-pod`` on 512, in subprocesses that see
               no card, each record ``ok`` and its roofline printed; (b)
               meanwhile, meshless on the card, qwen3-0.6b bf16 at full
               width and depth: a prefill of 8 x 2,048 (caches of 2,080),
               one decode step on that cache and a train step of 4 x 4,096;
               (c) mamba2-2.7b with 2 blocks, float32, a prefill of 2 x
               1,000. Each warm step is traced on the card and on ``meta``:
               FLOPs, bytes, kernel calls and collectives equal, the kernel
               calls equal the launch counters (28 B3; 28 B4; none; 2 B5),
               and the counter's peak within 5 % + 256 MiB of
               ``max_memory_allocated``; the memory breakdown (the live
               storages at the peak by the operator that made them) and the
               step's ms against its roofline bound are printed.

Training runs on none of the hand-written kernels, as the reference trains
on none of its Pallas kernels: the ``kernels`` line below is the serving
and planning paths'.

Kernel launch counters are zeroed just before each solve path and each
counted serve call and read just after; every solve's plans are replayed
by the numpy oracle ``simulate_np``. The last lines are the kernels' JSON
summary, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.analysis import HW  # noqa: E402

RTOL = 1e-5          # kernel vs plain version: both float32
#: plan cost vs the float64 numpy oracle: a float32 running sum over up to
#: 11,100 edges (Fig. 8) drifts ~1e-5 relative from the float64 sum
ORACLE_RTOL = 1e-4
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and bf16 dense
#: tensor-core FLOP/s (``launch.analysis.HW``, the dry run's figures), f32
#: non-tensor FLOP/s
HBM_BYTES_PER_S = HW().hbm_bw
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = HW().peak_flops
#: the H100's L2 cache (NVIDIA data sheet): B4's cold figure rotates over
#: copies of a cache that exceed four times it
L2_BYTES = 50 * 10 ** 6
#: device spin ahead of a timed stretch of attention calls (~25 ms at the
#: H100's clocks), so the host queues every call before the stretch starts
SLEEP_CYCLES = 50_000_000
#: attention kernels vs plain versions: the reference kernel tests'
#: tolerances (float32 sums in another order; bfloat16 outputs rounded)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: B5 vs its plain version: the reference kernel test's float32 tolerance
SSD_TOL = 1e-4
#: B4's log-sum-exp vs its plain version's (float32 at either dtype: the
#: same score products summed in another order), absolute and relative
LSE_TOL = 2e-5
#: H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet): B5's route runs
#: three TF32 products (3xTF32) for every float32 one
TF32_OPS_PER_S = 494.7e12
#: B1's walk, corrected mode (csrc/schedule_sim.cu): from one step's end to
#: the next step's, the dependent chain is an add (the parent's end + tt),
#: two maxes (the gate, then against the lease) and an add (+ exe); the
#: previous end and the next lease sit in registers, and the ring's and the
#: lease's shared-memory loads are issued a step ahead, off the chain. The
#: latency of a dependent FP32 add or max is assumed ~4 cycles, the size
#: that microbenchmarks of Hopper report (Luo et al., "Benchmarking and
#: Dissecting the Nvidia Hopper GPU Architecture", 2024)
FP32_OP_CYCLES = 4
CHAIN_CYCLES = 4 * FP32_OP_CYCLES


def _phase(name, fn, failures, *args):
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception:                       # report every phase, then fail
        failures.append(name)
        traceback.print_exc()
        out = None
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def random_swarm(rng, prob, P, max_p):
    """Half link-aware particles, half uniform; anchors on the strongest
    servers; padded genes 0."""
    p, s = prob.num_layers, prob.num_servers
    X = np.zeros((P, max_p), np.int32)
    X[:, :p] = rng.integers(0, s, size=(P, p))
    home = np.where(prob.pinned >= 0, prob.pinned, 0)
    home = np.maximum.reduceat(home, np.r_[0, np.flatnonzero(
        np.diff(prob.app_id)) + 1])[prob.app_id]
    reach = prob.link_ok[home] | (np.arange(s)[None, :] == home[:, None])
    half = P // 2
    for j in range(p):
        X[:half, j] = rng.choice(np.flatnonzero(reach[j]), size=half)
    X[:2, :p] = np.argsort(-prob.power, kind="stable")[:2, None]
    pinned = prob.pinned >= 0
    X[:half, :p][:, pinned] = prob.pinned[pinned]
    return X


def bound_ms(ppb, P, faithful):
    """Least time for one replay of P particles per problem of the stacked
    ``ppb``: the larger of bytes moved over HBM bandwidth and f32
    operations over the non-tensor f32 peak, counted from the problems'
    real layers and edges."""
    N, max_p = ppb.order.shape
    L = int((ppb.order >= 0).sum())
    E = int((ppb.parent_idx >= 0).sum())
    S, A = ppb.max_servers, int(ppb.deadline.shape[-1])
    max_in, max_out = ppb.parent_idx.shape[-1], ppb.child_idx.shape[-1]
    nbytes = N * (P * max_p * 4                      # genes
                  + max_p * 4 * 4                    # order/compute/app/pin
                  + max_p * (max_in + max_out) * 8   # relatives, MBs
                  + A * 4 + S * 8 + S * S * 9        # deadline, servers
                  + P * 9)                           # outputs
    per_edge = 4 if faithful else 6                  # tt, max, [end+tt, gate],
    #                                                  tran*mb, sum
    ops = P * (L * 9 + E * (per_edge + 2) + N * (3 * S + 2 * A + 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def chain_bound_ms(ppb, sm_mhz):
    """Least time of B1's walk as a chain: the longest problem's real steps
    times ``CHAIN_CYCLES`` at the SM clock ``sm_mhz`` (the problems and
    particles run side by side)."""
    steps = int((ppb.order >= 0).sum(-1).max())
    return 1e3 * steps * CHAIN_CYCLES / (sm_mhz * 1e6)


def smi_field(field):
    """One ``nvidia-smi --query-gpu`` field of card 0, as printed."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def traffic_bound_ms(ppb, tin, P, faithful):
    """Least time for one traffic replay of P particles per draw on the
    stacked ``ppb`` under the merged orders ``tin``: bytes (inputs once,
    outputs once, no latency grid) over HBM bandwidth against f32
    operations over the non-tensor f32 peak. The walk's work is counted
    from this run's real steps: 9 operations per step, per parent edge 4
    (faithful) or 6 (corrected), per child edge 2, plus the epilogue."""
    N, max_p = ppb.order.shape
    M = tin.slot_m.shape[1]
    A, R = tin.arr2.shape[-2:]
    S = ppb.max_servers
    max_in, max_out = ppb.parent_idx.shape[-1], ppb.child_idx.shape[-1]
    nv = tin.n_valid.cpu().numpy()
    slots = tin.slot_m.cpu().numpy()
    indeg = (ppb.parent_idx >= 0).sum(-1).cpu().numpy()      # (N, max_p)
    outdeg = (ppb.child_idx >= 0).sum(-1).cpu().numpy()
    per_edge = 4 if faithful else 6
    ops = 0
    for n in range(N):
        for m in range(M):
            j = slots[n, m, :nv[n, m]] % max_p
            ops += P * (9 * j.size + per_edge * int(indeg[n, j].sum())
                        + 2 * int(outdeg[n, j].sum()))
    ops += N * M * P * (3 * S + 4 * A * R + 2)
    nbytes = (N * P * max_p * 4                      # genes
              + N * max_p * 16                       # order/compute/app/pin
              + N * max_p * (max_in + max_out) * 8   # relatives, MBs
              + N * (A * 4 + S * 8 + S * S * 9)      # deadline, servers
              + 8 * int(nv.sum()) + 4 * N * M        # walked steps, n_valid
              + 5 * N * M * A * R                    # arr2, req_valid
              + N * M * P * 12 + N * P)              # outputs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def flash_plain(q, k, v, causal=True, window=0):
    """B3's plain version on the model layout: q (B,S,K,G,hd), k/v
    (B,S,K,hd)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    return flash_attention_plain(
        q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3),
        v.permute(0, 2, 1, 3), causal=causal,
        window=window).permute(0, 3, 1, 2, 4)


def decode_plain(q, k, v, valid_len, return_lse=False):
    """B4's plain version on the model layout: q (B,K,G,hd), k/v the
    (B,C,K,hd) cache."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    return decode_attention_plain(q, k.permute(0, 2, 1, 3),
                                  v.permute(0, 2, 1, 3), valid_len,
                                  return_lse)


def ssd_plain(xc, cum, Bc, Cc):
    """B5's plain version on the model layout: xc (b,c,q,h,p), cum
    (b,c,q,h), Bc/Cc (b,c,q,n)."""
    from repro_torch.kernels.ssd_scan import ssd_intra_plain
    b, c = xc.shape[:2]
    return ssd_intra_plain(*(t.flatten(0, 1) for t in (xc, cum, Bc, Cc))
                           ).unflatten(0, (b, c))


@contextlib.contextmanager
def plain_kernels():
    """Route the model's attention and SSD intra-chunk form through the
    plain versions on the card, to compare a model run through the kernels
    with the same run without them."""
    from repro_torch.kernels import ops
    saved = ops.flash_attention, ops.decode_attention, ops.ssd_intra
    ops.flash_attention, ops.decode_attention, ops.ssd_intra = \
        flash_plain, decode_plain, ssd_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention, ops.ssd_intra = saved


#: train-check: float32 gradients on the card against the CPU's, the same
#: weights and batch: ``‖g_cuda − g_cpu‖ ≤ GRAD_RTOL ‖g_cpu‖`` per tensor
#: (float32 sums in other orders, TF32 off; the CPU parity tests measure
#: ≤ 4.3e-6 against the reference), the loss to LOSS_RTOL
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5


def ptxas_report(log, entry):
    """(the groups of ``entry``, ptxas's spill and register lines) for each
    kernel instance whose mangled name matches the regular expression
    ``entry`` in an nvcc ``-Xptxas=-v`` log (none for a cached build)."""
    lines = (log or "").splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry.*" + entry, line)
        if m:
            body = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "spill" in x or "Used" in x]
            if body:
                out.append((m.groups(), "; ".join(body)))
    return out


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def _kernel_launches():
    """(B3, B4, B5) launch counters."""
    from repro_torch.launch.serve import kernel_launches
    return kernel_launches()


def train_check(dev):
    """train-check: the training route (each model's ``loss_fn``, backward)
    on the card against the same route on the CPU, from the same seeded
    float32 weights and batch: qwen3-0.6b with 2 layers, mamba2-2.7b with 2
    blocks, whisper-medium with 2 + 2 layers, full width, batch 2 of the
    data stream at sequence 256 (whisper: 1,500 frames, 187 + 1 tokens).
    Every parameter gets a finite gradient on the card, within GRAD_RTOL of
    the CPU's; the loss within LOSS_RTOL; no kernel launches."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_stream
    from repro_torch.models import build_model
    runs = [dataclasses.replace(get("qwen3-0.6b"), n_layers=2),
            dataclasses.replace(get("mamba2-2.7b"), n_layers=2),
            dataclasses.replace(get("whisper-medium"), enc_layers=2,
                                dec_layers=2)]
    for cfg in runs:
        cfg = dataclasses.replace(cfg, dtype="float32")
        seq = 1500 if cfg.family == "encdec" else 256
        batch = make_stream(cfg, ShapeSpec("train-check", seq, 2,
                                           "train")).batch(0)
        t0 = time.perf_counter()
        card = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        host = build_model(cfg, device="cpu")
        host.load_state_dict({n: t.cpu() for n, t in
                              card.state_dict().items()})
        out = {}
        for tag, model in (("cuda", card), ("cpu", host)):
            model.requires_grad_(True)
            before = _kernel_launches()
            loss, _ = model.loss_fn(batch)
            loss.backward()
            if tag == "cuda":
                torch.cuda.synchronize(dev)
            assert _kernel_launches() == before, (
                cfg.name, before, _kernel_launches())
            out[tag] = (float(loss.detach()), {n: p.grad for n, p in
                                      model.named_parameters()})
        (lc, g_card), (lh, g_host) = out["cuda"], out["cpu"]
        worst, worst_name = 0.0, ""
        for name, g in g_card.items():
            assert g is not None, f"{cfg.name}: {name} has no gradient"
            assert bool(torch.isfinite(g).all()), f"{cfg.name}: {name}"
            want = g_host[name]
            rel = float((g.cpu() - want).norm()) / max(float(want.norm()),
                                                       1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        shapes = {k: v.shape for k, v in batch.items()}
        depth = f"{cfg.enc_layers} + {cfg.dec_layers}" \
            if cfg.family == "encdec" else cfg.n_layers
        print(f"[train-check] {cfg.name}: {depth} layers, batch "
              f"{shapes}: loss cuda {lc!r} cpu {lh!r} (rel "
              f"{abs(lc - lh) / abs(lh):.2e}); {len(g_card)} gradients, worst "
              f"relative norm error {worst:.3e} ({worst_name}); kernel "
              f"launches 0 ({time.perf_counter() - t0:.1f} s)", flush=True)
        assert abs(lc - lh) <= LOSS_RTOL * abs(lh), (cfg.name, lc, lh)
        assert worst <= GRAD_RTOL, (cfg.name, worst_name, worst)
        del card, host, out, g_card, g_host
        free_card()


def train_run(dev):
    """train: qwen3-0.6b at full width and depth, bfloat16, through
    ``Trainer`` exactly as ``python -m repro_torch.launch.train --arch
    qwen3-0.6b --steps 8 --batch 4 --seq 4096 --ckpt-every 4 --fail-at 6
    --log-every 1 --ckpt-dir DIR`` runs it (train_4k's sequence, its global
    batch cut from 256 to 4 for one card). The failure before step 6
    restores the step-4 checkpoint and re-runs steps 5-7. Asserts: the
    loss falls (step 7 below step 0); the first re-run step (5) has the
    first pass's loss bit for bit, since it depends only on the restored
    state; the restored bfloat16 parameters, float32 moments and step
    count equal the ones entering step 5 in the first pass bit for bit; no
    kernel launches. Prints step ms (median after the first step),
    tokens/s, 6·N·tokens / step time / 989 TFLOP/s and peak memory."""
    import tempfile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train as train_cli
    from repro_torch.models import model_flops, param_count
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as ckpt:
        args = train_cli.parse_args([
            "--arch", "qwen3-0.6b", "--steps", "8", "--batch", "4",
            "--seq", "4096", "--ckpt-dir", ckpt, "--ckpt-every", "4",
            "--fail-at", "6", "--log-every", "1"])
        trainer = train_cli.trainer_from_args(args)
        cfg = trainer.cfg
        n_par = sum(p.numel() for p in trainer.params.values())
        print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.dtype}, remat {cfg.remat}, ce_chunk "
              f"{cfg.ce_chunk}, {n_par} parameters; batch {args.batch} x "
              f"{args.seq}", flush=True)
        entering5 = []            # the state entering step 5, each time

        def on_step(step, opt):
            if step == 5:
                entering5.append([{n: t.detach().to("cpu", copy=True)
                                   for n, t in tensors.items()}
                                  for tensors in (trainer.params, opt.mu,
                                                  opt.nu,
                                                  {"count": opt.count})])

        before = _kernel_launches()
        t0 = time.perf_counter()
        out = trainer.train(on_step=on_step)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        assert _kernel_launches() == before, (before, _kernel_launches())
    recs = out["metrics"]
    steps = [r["step"] for r in recs]
    print(f"[train] steps run {steps}, final step {out['final_step']}, "
          f"stragglers {out['stragglers']}, wall {wall:.1f} s (checkpoints "
          f"and the restore included)", flush=True)
    assert out["final_step"] == 7 and steps == [0, 1, 2, 3, 4, 5, 5, 6, 7], \
        steps
    first, rerun = recs[5], recs[6]
    print(f"[train] step 5 loss first pass {first['loss']!r}, after the "
          f"restore {rerun['loss']!r}; grad norm {first['grad_norm']!r} / "
          f"{rerun['grad_norm']!r}", flush=True)
    assert rerun["loss"] == first["loss"], (first, rerun)
    assert len(entering5) == 2, len(entering5)

    def bits(t):                  # bfloat16 and float32 as their words
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    for saved, restored in zip(*entering5):
        for n, t in saved.items():
            assert torch.equal(bits(t), bits(restored[n])), n
    assert recs[-1]["loss"] < recs[0]["loss"], (recs[0], recs[-1])
    dts = sorted(r["dt"] for r in recs[1:])
    step_s = dts[len(dts) // 2]
    tokens = args.batch * args.seq
    shape = ShapeSpec("train_4k, batch cut to 4", args.seq, args.batch,
                      "train")
    flops = model_flops(cfg, shape)
    print(f"[train] losses {[round(r['loss'], 4) for r in recs]}", flush=True)
    print(f"[train] step {1e3 * step_s:.1f} ms (median of {len(dts)} steps "
          f"after the first; all {[round(1e3 * d, 1) for d in dts]}), "
          f"{tokens / step_s:.0f} tokens/s, 6*N*tokens / step time / 989 "
          f"TFLOP/s = {flops / step_s / BF16_OPS_PER_S:.4f} (N = "
          f"{param_count(cfg, active_only=True) - cfg.vocab * cfg.d_model} "
          f"non-embedding parameters), peak device memory "
          f"{peak / 1e9:.3f} GB; restored state bit for bit", flush=True)
    print(f"[train] card: {smi_field('name,power.limit')}", flush=True)


def mesh_rank(rank: int, tmp: str) -> int:
    """``--mesh-rank RANK DIR``: one of two ranks that share this card and
    meet over ``gloo`` (a ``FileStore`` in DIR): qwen3-0.6b's plan and its
    bursty-traffic plan sharded over ``elastic_mesh(model=1)``, the
    results written to DIR for the parent to compare."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2),
                            rank=rank, world_size=2)
    torch.cuda.set_device(0)
    import repro_torch.core as port
    from repro_torch.configs import SHAPES, get
    from repro_torch.kernels import schedule_sim, traffic_sim
    from repro_torch.launch.plan import DEADLINE_RATIO, DEFAULT_PSO
    from repro_torch.runtime import elastic_mesh
    b1, b2 = schedule_sim.schedule_replay, traffic_sim.traffic_replay
    mesh = elastic_mesh(model=1)
    requests = [(get("qwen3-0.6b"), s, DEADLINE_RATIO) for s in SHAPES
                if s.kind != "train"]
    out = {}
    for tag, tc in (("plan", None),
                    ("traffic", port.TrafficConfig(kind="bursty", rate=0.5))):
        b1.launches = b2.launches = 0
        t0 = time.perf_counter()
        plans = port.plan_offload_batch(
            requests, env=port.tpu_fleet_environment(), pso=DEFAULT_PSO,
            seed=SEED, traffic=tc, mesh=mesh)
        torch.cuda.synchronize()
        print(f"[mesh] rank {rank} of 2 (gloo, cuda:0, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}): {tag} in "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms, launches B1 "
              f"{b1.launches} B2 {b2.launches}", flush=True)
        assert b1.launches > 0 and (b2.launches > 0) == (tc is not None)
        res = [p.result for p in plans]
        for i, r in enumerate(res):
            out[f"{tag}.x{i}"] = r.best_x
        out[f"{tag}.fit"] = np.array([r.best_fitness for r in res])
        out[f"{tag}.cost"] = np.array([r.best_cost for r in res])
        out[f"{tag}.it"] = np.array([r.iterations for r in res])
        out[f"{tag}.feas"] = np.array([r.feasible for r in res])
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    dist.destroy_process_group()
    return 0


#: serve-mesh's float32 checks: (tag, arch, layers), full width, batch 2 x
#: MESH_PROMPT tokens and MESH_STEPS greedy steps (mixtral's 2,000 tokens
#: keep every routed entry)
MESH_CHECKS = (("qwen3", "qwen3-0.6b", 2), ("mamba2", "mamba2-2.7b", 2),
               ("mixtral", "mixtral-8x7b", 2))
MESH_PROMPT, MESH_STEPS = 1000, 4


def mesh_check_cfg(arch, layers):
    from repro_torch.configs import get
    return dataclasses.replace(get(arch), n_layers=layers, dtype="float32")


def greedy_run(model, batch, steps, force=None):
    """The prefill of ``batch`` and ``steps`` greedy decode steps (fed
    back, or ``force``'s tokens): every step's logits (B, 1 + steps, V) as
    float32 and the tokens (B, steps)."""
    s0 = sum(batch[k].shape[1] for k in ("vision", "tokens") if k in batch)
    with torch.inference_mode():
        lg, c = model.prefill(batch, cache_len=s0 + steps)
        logits, toks = [lg], []
        for j in range(steps):
            toks.append(logits[-1][:, -1].argmax(-1)[:, None])
            feed = toks[-1] if force is None else force[:, j:j + 1]
            lg, c = model.decode_step(c, {"token": feed, "pos": s0 + j})
            logits.append(lg)
    return torch.cat(logits, 1).float(), torch.cat(toks, 1)


def serve_rank(rank: int, tmp: str) -> int:
    """``--serve-rank RANK DIR``: one of two ranks that share this card and
    meet over ``gloo`` (a ``FileStore`` in DIR), serving on
    ``elastic_mesh(model=2)``, ``(data 1, model 2)``: qwen3-0.6b at full
    width and depth in bfloat16 (its launches, the heads each kernel call
    saw, prefill, decode and peak memory; tokens against the world of
    one's in DIR), the float32 ``MESH_CHECKS`` against the meshless runs
    in DIR and against the plain kernels on this rank, and qwen3 on
    ``(data 2, model 1)``; results to DIR for the parent to check."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2),
                            rank=rank, world_size=2)
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.breakdown import (SERVE_BATCH, SERVE_NEW,
                                              SERVE_PROMPT)
    from repro_torch.launch.serve import Server, request_batch
    from repro_torch.models import build_model
    from repro_torch.runtime import elastic_mesh
    mesh = elastic_mesh(model=2)
    where = f"rank {rank} of 2 (gloo, cuda:0, mesh " \
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))})"
    ref = np.load(f"{tmp}/want.npz")
    out = {}
    # (1) qwen3-0.6b, full width and depth, bfloat16: the heads each B3 /
    # B4 call saw, recorded around the layout wrappers
    seen = set()
    flash, decode = ops.flash_attention, ops.decode_attention

    def rec_flash(q, k, v, **kw):
        seen.add(("B3", q.shape[2] * q.shape[3], k.shape[2]))
        return flash(q, k, v, **kw)

    def rec_decode(q, k, v, valid_len, **kw):
        seen.add(("B4", q.shape[1] * q.shape[2], k.shape[2]))
        return decode(q, k, v, valid_len, **kw)
    qwen = get("qwen3-0.6b")
    srv = Server(qwen, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, eos_id=-1,
                 mesh=mesh, device=dev)
    srv.init_params(SEED)
    batch = request_batch(qwen, SERVE_BATCH, SERVE_PROMPT,
                          np.random.default_rng(SEED))
    first = srv.generate(batch)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.flash_attention, ops.decode_attention = rec_flash, rec_decode
    b0 = _kernel_launches()
    try:
        res = srv.generate(batch)
    finally:
        ops.flash_attention, ops.decode_attention = flash, decode
    got = tuple(a - b for a, b in zip(_kernel_launches(), b0))
    peak = torch.cuda.max_memory_allocated(dev)
    same = bool(np.array_equal(res["tokens"], ref["bf16.tokens"]))
    print(f"[serve-mesh] {where}: qwen3-0.6b {qwen.n_layers} layers "
          f"bfloat16, batch "
          f"{SERVE_BATCH} x {SERVE_PROMPT}, {SERVE_NEW} new: prefill "
          f"{1e3 * res['prefill_s']:.2f} ms, decode "
          f"{res['tokens_generated']} tokens in {1e3 * res['decode_s']:.2f} "
          f"ms ({res['decode_tok_per_s']:.1f} tok/s; first call "
          f"{1e3 * first['prefill_s']:.2f} ms, "
          f"{first['decode_tok_per_s']:.1f} tok/s), launches B3 {got[0]} "
          f"B4 {got[1]} B5 {got[2]}, (kernel, q heads, kv heads) "
          f"{sorted(seen)}, peak device memory {peak / 1e9:.3f} GB; tokens "
          f"equal the world of one's {same}", flush=True)
    out["bf16.launches"] = np.array(got)
    out["bf16.heads"] = np.array(sorted({(h, k) for _, h, k in seen}))
    out["bf16.tokens"] = res["tokens"]
    out["bf16.repeat"] = np.array(np.array_equal(res["tokens"],
                                                 first["tokens"]))
    del srv
    free_card()
    # (2) float32 at full width against the meshless runs, and each
    # rank's kernels against their plain versions inside the model
    for tag, arch, layers in MESH_CHECKS:
        cfg = mesh_check_cfg(arch, layers)
        model = build_model(cfg, device=dev, mesh=mesh).init(
            torch.Generator(device=dev).manual_seed(SEED))
        batch = request_batch(cfg, 2, MESH_PROMPT,
                              np.random.default_rng(SEED + 1))
        b0 = _kernel_launches()
        lk, tk = greedy_run(model, batch, MESH_STEPS)
        n = tuple(a - b for a, b in zip(_kernel_launches(), b0))
        with plain_kernels():
            lp, tp = greedy_run(model, batch, MESH_STEPS, force=tk)
        err = float((lk.cpu() - torch.from_numpy(ref[f"{tag}.logits"]))
                    .abs().max())
        plain = float((lk - lp).abs().max())
        blk = model.blocks[0]
        heads = blk.mamba["A_log"].shape[0] if cfg.family == "ssm" \
            else blk.attn["wq"].shape[1]
        print(f"[serve-mesh] {where}: float32 {layers}-layer {cfg.name}, "
              f"batch 2 x {MESH_PROMPT}, {MESH_STEPS} greedy steps, "
              f"{heads} heads a rank: logits vs meshless max_abs_err "
              f"{err:.3g}, tokens equal "
              f"{np.array_equal(tk.cpu().numpy(), ref[f'{tag}.tokens'])}; "
              f"kernels vs plain max_abs_err {plain:.3g}, tokens equal "
              f"{bool(torch.equal(tk, tp))}; launches (B3, B4, B5) {n}",
              flush=True)
        out[f"{tag}.logits"] = lk.cpu().numpy()
        out[f"{tag}.tokens"] = tk.cpu().numpy()
        out[f"{tag}.plain"] = lp.cpu().numpy()
        out[f"{tag}.plain_tokens"] = tp.cpu().numpy()
        out[f"{tag}.heads"] = np.array(heads)
        out[f"{tag}.launches"] = np.array(n)
        del model
        free_card()
    # (3) (data 2, model 1): each rank serves one of the two rows
    data2 = elastic_mesh(model=1)
    cfg = mesh_check_cfg("qwen3-0.6b", 2)
    model = build_model(cfg, device=dev, mesh=data2).init(
        torch.Generator(device=dev).manual_seed(SEED))
    lk, tk = greedy_run(model, request_batch(
        cfg, 2, MESH_PROMPT, np.random.default_rng(SEED + 1)), MESH_STEPS)
    err = float((lk.cpu() - torch.from_numpy(ref["qwen3.logits"]))
                .abs().max())
    print(f"[serve-mesh] rank {rank} of 2 (gloo, cuda:0, mesh "
          f"{dict(zip(data2.mesh_dim_names, data2.shape))}): float32 "
          f"2-layer qwen3-0.6b, one of 2 rows a rank: logits vs meshless "
          f"max_abs_err {err:.3g}, tokens equal "
          f"{np.array_equal(tk.cpu().numpy(), ref['qwen3.tokens'])}",
          flush=True)
    out["data2.logits"] = lk.cpu().numpy()
    out["data2.tokens"] = tk.cpu().numpy()
    np.savez(f"{tmp}/serve{rank}.npz", **out)
    dist.destroy_process_group()
    return 0


#: train-mesh (b): float32 models at full width, batch 4 x 256 tokens, 4
#: steps each, checkpoints every 2 steps: (tag, arch, layers, meshes)
TRAIN_MESH_RUNS = (("qwen3", "qwen3-0.6b", 2, ((2, 1), (1, 2))),
                   ("mixtral", "mixtral-8x7b", 1, ((1, 2),)))
TRAIN_MESH_SHAPE, TRAIN_MESH_STEPS = (256, 4), 4
TRAIN_MESH_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def mesh_trainer(cfg, shape, steps, dev, mesh=None, ckpt=None, fail_at=(),
                 opt=None):
    """A ``Trainer`` for ``cfg`` at ``shape`` (seq, batch) on ``mesh``
    (None: one device, no mesh), logging every step, checkpointing every 2
    steps into ``ckpt``, failing before the ``fail_at`` steps."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureInjector
    return Trainer(cfg, ShapeSpec("train-mesh", *shape, "train"),
                   TrainerConfig(steps=steps, log_every=1, ckpt_dir=ckpt,
                                 ckpt_every=2, keep_n=5),
                   AdamWConfig(**(opt or TRAIN_MESH_OPT)),
                   injector=FailureInjector(fail_at=tuple(fail_at)),
                   device=dev, mesh=mesh)


def train_mesh_cfg(arch, layers):
    from repro_torch.configs import get
    return dataclasses.replace(get(arch), n_layers=layers, dtype="float32")


def spawn_ranks(flag, tmp):
    """Two processes of this script (``flag RANK DIR``) sharing this card
    over ``gloo``; their output printed, their results from DIR."""
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r), tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(log.rstrip(), flush=True)
        assert p.returncode == 0, f"{flag} rank {r} failed"
    return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(2)]


def train_mesh(dev):
    """train-mesh: the ``Trainer`` on a device mesh (data- and
    tensor-parallel, ZeRO-1, re-sharded restore). (a) On the ``nccl``
    world of one, qwen3-0.6b at full width and depth in bfloat16, batch 4
    x 4,096, 4 steps: ``Trainer(mesh=elastic_mesh(model=1))`` is the
    meshless ``Trainer`` bit for bit (losses, norms, final parameters).
    (b) Two ``gloo`` ranks on this card (``--train-rank``): float32
    2-layer qwen3 at full width on ``(2, 1)`` and ``(1, 2)`` and 1-layer
    mixtral on ``(1, 2)``, losses within 1e-4 of the meshless runs here,
    each rank's ZeRO-1 moments 1/data of its parameters' elements, no
    kernel launched; qwen3's run on ``(2, 1)`` crashes before step 3, and
    its step-2 whole-tensor checkpoint restored on ``(1, 2)`` lands on the
    uninterrupted run's final loss (1e-4); mixtral's final state is
    checkpointed once (``save_peak``)."""
    from repro_torch.configs import get
    from repro_torch.runtime import elastic_mesh
    free_card()
    mesh = elastic_mesh(model=1)
    cfg = get("qwen3-0.6b")
    runs = {}
    for name, m in (("none", None), ("mesh", mesh)):
        t = mesh_trainer(cfg, (4096, 4), 4, dev, m,
                         opt=dict(lr=3e-4, warmup_steps=1, total_steps=4))
        torch.cuda.reset_peak_memory_stats(dev)
        before = _kernel_launches()
        out = t.train()
        assert _kernel_launches() == before
        recs = out["metrics"]
        runs[name] = ([r["loss"] for r in recs],
                      [r["grad_norm"] for r in recs],
                      {n: p.detach().cpu() for n, p in t.params.items()},
                      [round(1e3 * r["dt"], 1) for r in recs],
                      torch.cuda.max_memory_allocated(dev))
        del t, out
        free_card()
    (l0, g0, p0, dt0, pk0), (l1, g1, p1, dt1, pk1) = runs["none"], \
        runs["mesh"]
    same = l0 == l1 and g0 == g1 and all(torch.equal(p0[n], p1[n])
                                         for n in p0)
    print(f"[train-mesh] (a) qwen3-0.6b bfloat16, 28 layers, batch 4 x "
          f"4096, 4 steps: meshless losses {l0}, step ms {dt0}, peak "
          f"{pk0 / 1e9:.3f} GB; on {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
          f" (nccl) losses {l1}, step ms {dt1}, peak {pk1 / 1e9:.3f} GB; "
          f"losses, norms and final parameters bit for bit: {same}",
          flush=True)
    assert same
    del runs, p0, p1
    free_card()
    # (b) the meshless float32 runs here, then two gloo ranks
    want = {}
    for tag, arch, layers, _ in TRAIN_MESH_RUNS:
        t = mesh_trainer(train_mesh_cfg(arch, layers), TRAIN_MESH_SHAPE,
                         TRAIN_MESH_STEPS, dev)
        want[f"{tag}.loss"] = np.array([r["loss"] for r in
                                        t.train()["metrics"]])
        print(f"[train-mesh] meshless float32 {layers}-layer {arch}: losses "
              f"{want[f'{tag}.loss'].tolist()}", flush=True)
        del t
        free_card()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/want.npz", **want)
        got = spawn_ranks("--train-rank", tmp)
    for r, o in enumerate(got):
        for tag, _, _, meshes in TRAIN_MESH_RUNS:
            for shape in meshes:
                key = f"{tag}.{shape[0]}x{shape[1]}"
                steps = 3 if (tag, shape) == ("qwen3", (2, 1)) \
                    else TRAIN_MESH_STEPS
                assert len(o[f"{key}.loss"]) == steps, (key, steps)
                np.testing.assert_allclose(o[f"{key}.loss"],
                                           want[f"{tag}.loss"][:steps],
                                           rtol=1e-4,
                                           err_msg=f"rank {r} {key}")
                np.testing.assert_array_equal(o[f"{key}.loss"],
                                              got[0][f"{key}.loss"])
                assert int(o[f"{key}.mu"]) * shape[0] == int(o[f"{key}.n"])
                assert not o[f"{key}.launches"].any()
        assert o["resumed.step"].tolist() == [3], o["resumed.step"]
        np.testing.assert_allclose(o["resumed.loss"][-1],
                                   want["qwen3.loss"][-1], rtol=1e-4)
    print("[train-mesh] (b) two gloo ranks on cuda:0: float32 qwen3 on "
          "(2, 1) and (1, 2) and mixtral on (1, 2) within 1e-4 of the "
          "meshless losses, ranks equal, ZeRO-1 moments 1/data a rank, no "
          "kernel launched; crashed on (2, 1), restored on (1, 2) onto the "
          "uninterrupted final loss", flush=True)


def save_peak(t, rank, ckpt, dev):
    """A whole-tensor checkpoint of trainer ``t``'s final state on its
    mesh, its device memory above the resident state printed (each leaf
    gathered in turn: under two of the largest whole leaf, where the whole
    tree at once would be ten bytes a parameter), then deleted."""
    from repro_torch.checkpoint import CheckpointManager
    t.mgr = CheckpointManager(ckpt, keep_n=1)
    free_card()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    t._save(t.tcfg.steps - 1, t._final, blocking=True)
    wall = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated(dev) - base
    leaf = max(math.prod(t.plan.full[n]) * p.element_size()
               for n, p in t.params.items())
    print(f"[train-mesh] rank {rank} of 2: checkpoint of {t.cfg.name} "
          f"({len(t.params)} whole parameters and their moments) in "
          f"{wall:.1f} s, device memory above the resident "
          f"{base / 1e9:.3f} GB: {extra / 1e9:.3f} GB (largest whole "
          f"float32 leaf {leaf / 1e9:.3f} GB)", flush=True)
    assert extra <= 2 * leaf, (extra, leaf)
    t.mgr = None
    shutil.rmtree(ckpt, ignore_errors=True)


def train_rank(rank: int, tmp: str) -> int:
    """``--train-rank RANK DIR``: one of two ranks that share this card and
    meet over ``gloo``: the ``TRAIN_MESH_RUNS`` trainers on their meshes,
    qwen3's on ``(2, 1)`` checkpointing and crashing before step 3, and its
    step-2 checkpoint restored on ``(1, 2)``; results to DIR."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2),
                            rank=rank, world_size=2)
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.runtime import SimulatedFailure
    out, ckpt = {}, f"{tmp}/ckpt"
    for tag, arch, layers, meshes in TRAIN_MESH_RUNS:
        cfg = train_mesh_cfg(arch, layers)
        for shape in meshes:
            mesh = build_mesh(None, shape, ("data", "model"))
            key = f"{tag}.{shape[0]}x{shape[1]}"
            crash = (tag, shape) == ("qwen3", (2, 1))
            torch.cuda.reset_peak_memory_stats(dev)
            t = mesh_trainer(cfg, TRAIN_MESH_SHAPE, TRAIN_MESH_STEPS, dev,
                             mesh, ckpt=ckpt if crash else None,
                             fail_at=(3,) if crash else ())
            mu = []

            def on_step(step, opt):
                mu.append(sum(m.numel() for m in opt.mu.values()))
            before = _kernel_launches()
            t0 = time.perf_counter()
            try:
                t.train(max_restarts=0, on_step=on_step)
                assert not crash, "no failure was injected"
            except SimulatedFailure:
                assert crash
                t.mgr.wait()
            recs = t.metrics_log
            wall = time.perf_counter() - t0
            n = [a - b for a, b in zip(_kernel_launches(), before)]
            par = sum(p.numel() for p in t.params.values())
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"[train-mesh] rank {rank} of 2 (gloo, cuda:0, mesh "
                  f"{shape}): float32 {layers}-layer {arch}, batch "
                  f"{TRAIN_MESH_SHAPE[1]} x {TRAIN_MESH_SHAPE[0]}: losses "
                  f"{[r['loss'] for r in recs]}, step ms "
                  f"{[round(1e3 * r['dt'], 1) for r in recs]} (wall "
                  f"{wall:.1f} s{', crashed before step 3' if crash else ''}"
                  f"), parameters {par} and moment elements {mu[-1]} a rank, "
                  f"peak device memory {peak / 1e9:.3f} GB, launches (B3, "
                  f"B4, B5) {tuple(n)}", flush=True)
            out[f"{key}.loss"] = np.array([r["loss"] for r in recs])
            out[f"{key}.mu"] = np.array(mu[-1])
            out[f"{key}.n"] = np.array(par)
            out[f"{key}.launches"] = np.array(n)
            if tag == "mixtral":
                save_peak(t, rank, f"{tmp}/ckpt-{tag}", dev)
            del t
            free_card()
    dist.barrier()
    resumed = mesh_trainer(train_mesh_cfg("qwen3-0.6b", 2), TRAIN_MESH_SHAPE,
                           TRAIN_MESH_STEPS, dev,
                           build_mesh(None, (1, 2), ("data", "model")),
                           ckpt=ckpt)
    recs = resumed.train()["metrics"]
    print(f"[train-mesh] rank {rank} of 2: restored on (1, 2) from the (2, "
          f"1) run's step-2 checkpoint: steps {[r['step'] for r in recs]}, "
          f"losses {[r['loss'] for r in recs]}", flush=True)
    out["resumed.step"] = np.array([r["step"] for r in recs])
    out["resumed.loss"] = np.array([r["loss"] for r in recs])
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    dist.destroy_process_group()
    return 0


#: seq-decode's float32 models at full width: (tag, arch, fields replaced)
SEQ_CHECKS = (("qwen3", "qwen3-0.6b", {"n_layers": 2}),
              ("gemma3", "gemma3-27b", {"n_layers": 2}),
              ("zamba2", "zamba2-7b", {"n_layers": 7}),
              ("whisper", "whisper-medium", {"enc_layers": 2,
                                             "dec_layers": 2}))


def seq_run(model, batch, prompt, new):
    """A batch-1 prefill of ``batch`` (``prompt`` positions, caches of
    ``prompt + new`` slots) and ``new - 1`` greedy decode steps from
    position ``prompt``, as ``Server.generate``: every step's logits
    (float32) and the tokens."""
    with torch.inference_mode():
        lg, c = model.prefill(batch, cache_len=prompt + new)
        logits, toks = [lg.float()], [lg[:, -1].argmax(-1)[:, None]]
        for j in range(new - 1):
            lg, c = model.decode_step(c, {"token": toks[-1],
                                          "pos": prompt + j})
            logits.append(lg.float())
            toks.append(lg[:, -1].argmax(-1)[:, None])
    return torch.cat(logits, 1), torch.cat(toks, 1)


def seq_models(dev, mesh=None):
    """Each ``SEQ_CHECKS`` model with seeded weights on ``mesh`` and its
    one-row request batch."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import request_batch
    from repro_torch.models import build_model
    for tag, arch, kw in SEQ_CHECKS:
        cfg = dataclasses.replace(get(arch), dtype="float32", **kw)
        model = build_model(cfg, device=dev, mesh=mesh).init(
            torch.Generator(device=dev).manual_seed(SEED))
        yield tag, model, request_batch(cfg, 1, SEQ_PROMPT,
                                        np.random.default_rng(SEED + 2))


#: seq-decode: a batch of 1, prompt 2,048 and 32 new tokens
SEQ_PROMPT, SEQ_NEW = 2048, 32
#: a card's slots of qwen3-0.6b's batch-1 cache over four cards (prompt
#: 32,768 and 32 new tokens, sequence-parallel decode): B4's longest rows
SLICE_SLOTS = (32768 + SEQ_NEW) // 4


def seq_decode(dev):
    """seq-decode: batch-1 sequence-parallel decode (the reference's
    ``shard_seq``) on two ``gloo`` ranks sharing this card
    (``--seq-rank``), ``(data 2, model 1)``, prompt 2,048 and 32 new
    tokens: qwen3-0.6b in bfloat16 at full depth through ``Server`` (each
    rank's B4 over 1,040 of 2,080 slots; launches and per-rank slots
    printed, tokens against the meshless server's printed), then float32
    2-layer qwen3, gemma3 (local rings of 1,024, 512 a rank), 7-layer
    zamba2 and 2 + 2-layer whisper against the meshless batch-1 runs here
    (logits within 1e-4, tokens equal), the ranks bit for bit."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import Server, request_batch
    free_card()
    qwen = get("qwen3-0.6b")
    srv = Server(qwen, 1, SEQ_PROMPT, SEQ_NEW, eos_id=-1, device=dev)
    srv.init_params(SEED)
    want = {"bf16.tokens": srv.generate(request_batch(
        qwen, 1, SEQ_PROMPT, np.random.default_rng(SEED)))["tokens"]}
    del srv
    free_card()
    for tag, model, batch in seq_models(dev):
        lg, tk = seq_run(model, batch, SEQ_PROMPT, SEQ_NEW)
        want[f"{tag}.logits"] = lg.cpu().numpy()
        want[f"{tag}.tokens"] = tk.cpu().numpy()
        del model
        free_card()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/want.npz", **want)
        got = spawn_ranks("--seq-rank", tmp)
    layers = qwen.n_layers
    for r, o in enumerate(got):
        assert tuple(o["bf16.launches"]) == (layers, layers * (SEQ_NEW - 1),
                                             0), o["bf16.launches"]
        assert int(o["bf16.slots"]) == (SEQ_PROMPT + SEQ_NEW) // 2
        for tag, _, _ in SEQ_CHECKS:
            np.testing.assert_allclose(o[f"{tag}.logits"],
                                       want[f"{tag}.logits"], rtol=1e-4,
                                       atol=1e-4, err_msg=f"rank {r} {tag}")
            np.testing.assert_array_equal(o[f"{tag}.tokens"],
                                          want[f"{tag}.tokens"])
        for k in o:
            np.testing.assert_array_equal(o[k], got[0][k], err_msg=k)
    print(f"[seq-decode] two gloo ranks on cuda:0, batch 1 x {SEQ_PROMPT}, "
          f"{SEQ_NEW} new: qwen3-0.6b bfloat16 B3 {layers} and B4 "
          f"{layers * (SEQ_NEW - 1)} launches a rank over "
          f"{(SEQ_PROMPT + SEQ_NEW) // 2} slots a rank, tokens equal the "
          f"meshless server's "
          f"{np.array_equal(got[0]['bf16.tokens'], want['bf16.tokens'])}; "
          f"float32 qwen3, gemma3, zamba2 and whisper within 1e-4 of the "
          f"meshless batch-1 runs, tokens equal, ranks bit for bit",
          flush=True)


def seq_rank(rank: int, tmp: str) -> int:
    """``--seq-rank RANK DIR``: one of two ranks that share this card and
    meet over ``gloo``, serving a batch of 1 on ``(data 2, model 1)``;
    results to DIR."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2),
                            rank=rank, world_size=2)
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.serve import Server, request_batch
    mesh = build_mesh(None, (2, 1), ("data", "model"))
    where = f"rank {rank} of 2 (gloo, cuda:0, mesh {{'data': 2, 'model': 1}})"
    want = np.load(f"{tmp}/want.npz")
    out = {}
    qwen = get("qwen3-0.6b")
    srv = Server(qwen, 1, SEQ_PROMPT, SEQ_NEW, eos_id=-1, mesh=mesh,
                 device=dev)
    srv.init_params(SEED)
    batch = request_batch(qwen, 1, SEQ_PROMPT, np.random.default_rng(SEED))
    first = srv.generate(batch)
    torch.cuda.reset_peak_memory_stats(dev)
    b0 = _kernel_launches()
    res = srv.generate(batch)
    got = tuple(a - b for a, b in zip(_kernel_launches(), b0))
    peak = torch.cuda.max_memory_allocated(dev)
    caches = srv.model.init_caches(1, SEQ_PROMPT + SEQ_NEW)
    slots = int(caches["k"].shape[-3])
    own = srv.model.sh.seq_slots(SEQ_PROMPT + SEQ_NEW)
    print(f"[seq-decode] {where}: qwen3-0.6b {qwen.n_layers} layers "
          f"bfloat16, batch 1 x {SEQ_PROMPT}, {SEQ_NEW} new: slots "
          f"[{own.start}, {own.stop}) of {SEQ_PROMPT + SEQ_NEW} ({slots} a "
          f"layer), launches B3 {got[0]} B4 {got[1]} B5 {got[2]}, prefill "
          f"{1e3 * res['prefill_s']:.2f} ms, decode "
          f"{res['tokens_generated']} tokens in {1e3 * res['decode_s']:.2f} "
          f"ms ({res['decode_tok_per_s']:.1f} tok/s), peak device memory "
          f"{peak / 1e9:.3f} GB; tokens equal the meshless server's "
          f"{np.array_equal(res['tokens'], want['bf16.tokens'])}, repeat "
          f"equal {np.array_equal(res['tokens'], first['tokens'])}",
          flush=True)
    out["bf16.launches"] = np.array(got)
    out["bf16.slots"] = np.array(slots)
    out["bf16.tokens"] = res["tokens"]
    del srv, caches
    free_card()
    for tag, model, batch in seq_models(dev, mesh):
        b0 = _kernel_launches()
        lg, tk = seq_run(model, batch, SEQ_PROMPT, SEQ_NEW)
        n = tuple(a - b for a, b in zip(_kernel_launches(), b0))
        err = float((lg.cpu() - torch.from_numpy(want[f"{tag}.logits"]))
                    .abs().max())
        print(f"[seq-decode] {where}: float32 {model.cfg.name}: logits vs "
              f"meshless max_abs_err {err:.3g}, tokens equal "
              f"{np.array_equal(tk.cpu().numpy(), want[f'{tag}.tokens'])}; "
              f"launches (B3, B4, B5) {n}", flush=True)
        out[f"{tag}.logits"] = lg.cpu().numpy()
        out[f"{tag}.tokens"] = tk.cpu().numpy()
        del model
        free_card()
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    dist.destroy_process_group()
    return 0


#: dryrun: the dry run's cells on 256 fake ranks (512 with --multi-pod)
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", ()),
                ("qwen3-0.6b", "decode_32k", ()),
                ("mixtral-8x7b", "prefill_32k", ("--multi-pod",)))
#: the counter's peak vs ``max_memory_allocated``: 5 % + 256 MiB (the
#: allocator's 512-byte rounding, cuBLAS's workspaces, kernels' scratch)
PEAK_RTOL, PEAK_SLACK = 0.05, 256 << 20
#: dryrun (b): qwen3-0.6b prefill and decode batch, prompt and cache
DRY_BATCH, DRY_PROMPT, DRY_CACHE = 8, 2048, 2080


def start_dryruns(tmp):
    """``python -m repro_torch.launch.dryrun`` on each ``DRYRUN_CELLS``
    cell, all started together, no card visible; returns the processes
    with their cells and output paths."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.pop("REPRO_DRYRUN_DEVICES", None)
    procs = []
    for arch, shape, flags in DRYRUN_CELLS:
        out = f"{tmp}/{arch}_{shape}.json"
        procs.append(((arch, shape, flags), out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *flags, "--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT)))
    return procs


def finish_dryruns(procs):
    """Wait for ``start_dryruns``' processes; each must exit 0 with an
    ``ok`` record, whose roofline is printed."""
    for (arch, shape, flags), out, proc in procs:
        text, _ = proc.communicate(timeout=900)
        print(text.strip(), flush=True)
        assert proc.returncode == 0, (arch, shape, proc.returncode)
        with open(out) as f:
            rec = json.load(f)
        assert rec["status"] == "ok", rec
        r, m, c = rec["roofline"], rec["memory"], rec["collective"]
        print(f"[dryrun] {arch} x {shape} {' '.join(flags)}: mesh "
              f"{rec['mesh']} ({rec['n_chips']} fake ranks), traced in "
              f"{rec['trace_s']} s; per chip {rec['flops_per_chip']:.4g} "
              f"FLOPs, {rec['hbm_bytes_per_chip']:.4g} bytes, "
              f"{c['count']} collectives ({c['ici_bytes']:.4g} bytes NVLink, "
              f"{c['dcn_bytes']:.4g} DCN), peak {m['peak_bytes'] / 1e9:.3f} "
              f"GB (fits 80 GB: {rec['fits_hbm']}); roofline compute "
              f"{1e3 * r['compute_s']:.4f} ms, memory "
              f"{1e3 * r['memory_s']:.4f} ms, collective "
              f"{1e3 * r['collective_s']:.4f} ms, dominant {r['dominant']}; "
              f"kernels {rec['kernel_calls']}", flush=True)


def dry_cells():
    """dryrun (b), (c): ``(tag, make, launches)``: ``make(device)`` builds
    a model there (seeded weights on the card), its step and the step's
    arguments; ``launches`` the (B3, B4, B5) launches the step must make."""
    from repro_torch.configs import get
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_train_objects
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    qwen = get("qwen3-0.6b")
    mamba = dataclasses.replace(get("mamba2-2.7b"), n_layers=2,
                                dtype="float32")

    def tokens(dev, b, s, vocab):
        if dev.type == "meta":
            return torch.zeros((b, s), dtype=torch.int32, device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        return torch.randint(0, vocab, (b, s), generator=g, device=dev,
                             dtype=torch.int32)

    def model_on(cfg, dev):
        model = build_model(cfg, device=dev)
        if dev.type != "meta":
            model.init(torch.Generator(device=dev).manual_seed(SEED))
        return model

    def prefill(cfg, batch, prompt, cache):
        def make(dev):
            model = model_on(cfg, dev)
            step = torch.no_grad()(
                lambda b: model.prefill(b, cache_len=cache))
            return model, step, ({"tokens": tokens(
                dev, batch, prompt, cfg.vocab)},)
        return make

    def decode(dev):
        model, step, (batch,) = prefill(qwen, DRY_BATCH, DRY_PROMPT,
                                        DRY_CACHE)(dev)
        _, caches = step(batch)
        return model, torch.no_grad()(model.decode_step), (caches, {
            "token": tokens(dev, DRY_BATCH, 1, qwen.vocab),
            "pos": DRY_PROMPT})

    def train(dev):
        model, step, _ = make_train_objects(
            qwen, ShapeSpec("train_4k, batch cut to 4", 4096, 4, "train"),
            device=dev)
        if dev.type != "meta":
            model.init(torch.Generator(device=dev).manual_seed(SEED))
        opt = adamw_init({n: step.plan.zslice(n, p)
                          for n, p in model.named_parameters()})
        return model, step, (opt, {"tokens": tokens(dev, 4, 4097,
                                                    qwen.vocab)})
    layers = qwen.n_layers
    return (("qwen3-0.6b prefill bf16 8 x 2048",
             prefill(qwen, DRY_BATCH, DRY_PROMPT, DRY_CACHE), (layers, 0, 0)),
            ("qwen3-0.6b decode step bf16 8 x 2080 slots", decode,
             (0, layers, 0)),
            ("qwen3-0.6b train step bf16 4 x 4096", train, (0, 0, 0)),
            ("mamba2-2.7b (2 blocks) prefill float32 2 x 1000",
             prefill(mamba, 2, 1000, 1000), (0, 0, 2)))


def dry_cell(dev, tag, make, launches):
    """One dryrun (b) / (c) cell: the warm step traced on the card and on
    ``meta`` (equal FLOPs, bytes, kernel calls and collectives; the kernel
    calls the launch counters'), the counter's peak against
    ``max_memory_allocated`` over what was resident before the model
    (``PEAK_RTOL`` + ``PEAK_SLACK``), and the step's ms against its
    roofline bound ``max(compute, memory)``."""
    from repro_torch.launch.analysis import (collective_bytes, roofline_terms,
                                             trace_step)
    free_card()
    base = torch.cuda.memory_allocated(dev)
    model, step, args = make(dev)
    live = [*model.parameters(), *model.buffers()]
    out = step(*args)                        # warm: builds, cuBLAS, caches
    del out
    gc.collect()
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    before = _kernel_launches()
    out, card = trace_step(step, *args, live=live)
    torch.cuda.synchronize(dev)
    measured = torch.cuda.max_memory_allocated(dev) - base
    got = tuple(a - b for a, b in zip(_kernel_launches(), before))
    del out
    times = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step(*args)
        ev[1].record()
        torch.cuda.synchronize(dev)
        times.append(ev[0].elapsed_time(ev[1]))
        del out
    ms = float(np.median(times))
    del model, step, args, live
    free_card()
    meta_model, meta_step, meta_args = make(torch.device("meta"))
    _, meta = trace_step(meta_step, *meta_args,
                         live=[*meta_model.parameters(),
                               *meta_model.buffers()])
    calls = card.kernels_by_name()
    by_kernel = tuple(calls.get(n, {}).get("calls", 0) for n in (
        "flash_attention", "decode_attention", "ssd_scan"))
    terms = roofline_terms(card.flops, card.bytes,
                           collective_bytes(card.collectives))
    bound = 1e3 * max(terms["compute_s"], terms["memory_s"])
    top = sorted(meta.peak_by_op.items(), key=lambda kv: -kv[1])[:6]
    print(f"[dryrun] {tag}: card {card.flops:.6g} FLOPs ({card.kernel_flops:.4g} "
          f"in kernels), {card.bytes:.6g} bytes, {card.ops} operators, "
          f"kernel calls {calls}, {len(card.collectives)} collectives; meta "
          f"equal: flops {meta.flops == card.flops}, bytes "
          f"{meta.bytes == card.bytes}, kernel calls "
          f"{meta.kernel_calls == card.kernel_calls}, collectives "
          f"{meta.collectives == card.collectives}; launches (B3, B4, B5) "
          f"{got}", flush=True)
    print(f"[dryrun] {tag}: memory (GB) argument "
          f"{meta.argument_bytes / 1e9:.3f} (resident before the step "
          f"{resident / 1e9:.3f}), output {meta.output_bytes / 1e9:.3f}, "
          f"alias {meta.alias_bytes / 1e9:.3f}, temp "
          f"{meta.temp_bytes / 1e9:.3f}, peak predicted "
          f"{meta.peak_bytes / 1e9:.3f} (card trace "
          f"{card.peak_bytes / 1e9:.3f}), measured {measured / 1e9:.3f} "
          f"(max_memory_allocated over {base / 1e9:.3f} resident before "
          f"the model); at the peak besides the arguments: "
          f"{', '.join(f'{k} {v / 1e9:.3f}' for k, v in top)}", flush=True)
    print(f"[dryrun] {tag}: step {ms:.3f} ms (median of "
          f"{[round(t, 3) for t in times]}), roofline compute "
          f"{1e3 * terms['compute_s']:.4f} ms, memory "
          f"{1e3 * terms['memory_s']:.4f} ms: bound {bound:.4f} ms, "
          f"{bound / ms:.4f} of the step", flush=True)
    assert (meta.flops, meta.bytes) == (card.flops, card.bytes), tag
    assert meta.kernel_calls == card.kernel_calls, tag
    assert meta.collectives == card.collectives, tag
    assert got == launches == by_kernel, (tag, got, launches, by_kernel)
    assert abs(meta.peak_bytes - measured) <= PEAK_RTOL * measured \
        + PEAK_SLACK, (tag, meta.peak_bytes, measured)
    del meta_model, meta_step, meta_args


def dryrun(dev):
    """dryrun: (a) the dry run on fake fleets in subprocesses, while (b)
    and (c) trace steps on the card and on ``meta``."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryruns(tmp)
        for tag, make, launches in dry_cells():
            dry_cell(dev, tag, make, launches)
        finish_dryruns(procs)
    print(f"[dryrun] card: {smi_field('name,power.limit')}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.core as port
    from repro_torch.core.batch import SYNC_EVERY
    from repro_torch.core.simulator import kernel_args
    from repro_torch.kernels import _build, schedule_sim, traffic_sim
    from repro_torch.core.paper import PAPER_PSO, fig8_problem

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    failures = []
    # the kernels' dispatches, each with its launch counter (not
    # ``port.traffic_replay``, which replays one plan through B2)
    b1 = schedule_sim.schedule_replay
    b2 = traffic_sim.traffic_replay
    rec = {"max_abs_err": 0.0, "traffic_max_abs_err": 0.0}

    # 1. build ------------------------------------------------------------
    def build():
        t0 = time.perf_counter()
        names = _build.SOURCES
        with ThreadPoolExecutor(len(names)) as pool:
            paths = list(pool.map(_build.build, names))
        for name, path in zip(names, paths):
            print(f"[build] {path.relative_to(ROOT)}")
            print(_build.build_log(name) or "(cached)")
        print(f"[build] {len(names)} kernels in "
              f"{time.perf_counter() - t0:.2f} s")
        for name in names:
            importlib.import_module(f"repro_torch.kernels.{name}")._lib()
        # B3's wgmma route: registers (the consumers get 240 at run time by
        # setmaxnreg), spills, shared memory
        from repro_torch.kernels import flash_attention as fa
        lib = fa._lib()
        log = _build.build_log("flash_attention")
        found = [(int(hd), line) for (hd,), line in ptxas_report(
            log, r"flash_bf16_wgmma_kernelILi(\d+)E")]
        if log is None:
            print("[build] B3 wgmma: library cached, ptxas not rerun")
        else:
            assert {hd for hd, _ in found} == set(fa.WGMMA_HEAD_DIMS), \
                f"ptxas lines for B3 wgmma at {[hd for hd, _ in found]}"
        for hd, line in found:
            print(f"[build] B3 wgmma hd {hd} kv tile "
                  f"{fa.tile_geometry(hd, torch.bfloat16)['bkv']}: {line}; "
                  f"{lib.flash_attention_wgmma_smem(hd)} bytes of dynamic "
                  f"shared memory", flush=True)
            assert " 0 bytes spill stores" in line and \
                " 0 bytes spill loads" in line, f"B3 wgmma hd {hd} spills"
        # the host's bf16 route and tiles (the CPU emulation's) are the
        # library's
        for hd in fa.HEAD_DIMS:
            for r in ("mma", "wgmma"):
                want = (fa.tile_geometry(hd, torch.bfloat16)
                        if fa.route(hd, torch.bfloat16) == r else None)
                got = fa.library_tiles(hd, r)
                assert got == want, f"B3 {r} hd {hd}: library {got}, host {want}"
        print("[build] B3 host routes and tiles match the library")
        # B4: every instance (dtype, head_dim, head group) without spills;
        # the host's tiles (work_split's, the CPU emulation's) the library's
        from repro_torch.kernels import decode_attention as da
        log = _build.build_log("decode_attention")
        found = ptxas_report(log, r"decode_(tma|merge)_kernelI"
                                  r"(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E")
        if log is None:
            print("[build] B4: library cached, ptxas not rerun")
        else:
            want = {(k, t, str(hd), str(gc)) for k in ("tma", "merge")
                    for t in ("f", "13__nv_bfloat16")
                    for hd in fa.HEAD_DIMS for gc in (1, 2, 4, 8)}
            assert {k for k, _ in found} == want, \
                f"ptxas lines for B4 at {sorted(k for k, _ in found)}"
        for (k, t, hd, gc), line in found:
            dt = torch.float32 if t == "f" else torch.bfloat16
            occ = (f"; {da._blocks_per_sm(int(hd), dt, int(gc))} blocks an SM"
                   if k == "tma" else "")
            print(f"[build] B4 {k} {str(dt)[6:]} hd {hd} heads {gc}: "
                  f"{line}{occ}", flush=True)
            assert " 0 bytes spill stores" in line and \
                " 0 bytes spill loads" in line, f"B4 {k} {t} {hd} {gc} spills"
        for hd in fa.HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                got = da.library_geometry(hd, dt)
                want = (*da.geometry(hd, dt), da.CONSUMER_WARPS)
                assert got == want, f"B4 {dt} hd {hd}: library {got}, host {want}"
        print("[build] B4 host tiles match the library")
        # B5: every instance (the wgmma kernel, the mma.sync one at column
        # tiles 16, 32, 64) without spills, no serialized wgmma; the host's
        # route (the CPU tests') the library's
        from repro_torch.kernels import ssd_scan
        log = _build.build_log("ssd_scan")
        found = ptxas_report(log, r"ssd_(wgmma_kernel|mma_kernelILi\d+E)")
        if log is None:
            print("[build] B5: library cached, ptxas not rerun")
        else:
            assert len(found) == 4, f"ptxas lines for B5: {found}"
            assert "serialized" not in log, "B5: ptxas serialized wgmma"
        for (k,), line in found:
            print(f"[build] B5 {k}: {line}", flush=True)
            assert " 0 bytes spill stores" in line and \
                " 0 bytes spill loads" in line, f"B5 {k} spills"
        print(f"[build] B5 wgmma: {ssd_scan._lib().ssd_scan_wgmma_smem()} "
              f"bytes of dynamic shared memory")
        for p_, n_ in ((64, 128), (64, 64), (64, 32), (32, 128), (16, 8),
                       (128, 64)):
            assert ssd_scan.library_route(p_, n_) == ssd_scan.route(p_, n_)
        print("[build] B5 host routes match the library")
    _phase("build", build, failures)

    # 2. check ------------------------------------------------------------
    env = port.paper_environment()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    fig8_dag, fig8_env = fig8_problem()
    fig8_prob = port.SimProblem.build(fig8_dag, fig8_env)
    print(f"[setup] fig8: {fig8_prob.num_layers} layers, "
          f"{fig8_prob.num_apps} apps, {fig8_prob.num_servers} servers "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    from repro_torch.configs import SHAPES, get
    from repro_torch.launch.plan import DEADLINE_RATIO, DEFAULT_PSO
    shapes = [s for s in SHAPES if s.kind != "train"]
    tpu_env = port.tpu_fleet_environment()

    def plan_bucket():
        """The bucket the main path solves: qwen3-0.6b's serving shapes
        lowered as ``plan_offload_batch`` lowers them."""
        probs = []
        for shape in shapes:
            d = port.arch_to_dag(get("qwen3-0.6b"), shape, pin_server=int(
                tpu_env.servers_of_tier(port.DEVICE)[0]))
            h, _ = port.heft_makespan(d, tpu_env)
            probs.append(port.SimProblem.build(
                d.with_deadline(np.array([DEADLINE_RATIO * h])), tpu_env))
        ppb = port.pack_problems(probs, device=dev)
        X = torch.as_tensor(np.stack([
            random_swarm(rng, pr, DEFAULT_PSO.pop_size, ppb.max_layers)
            for pr in probs]), device=dev)
        return ppb, X

    def fig8_bucket():
        """The Fig. 8 problem with a seeded swarm of 100 particles."""
        ppb = port.stack_problems([port.pad_problem(fig8_prob, device=dev)])
        X = torch.as_tensor(random_swarm(rng, fig8_prob, 100,
                                         fig8_prob.num_layers), device=dev)
        return ppb, X[None]

    def compare(tag, ppb, X, faithful):
        got = b1(*kernel_args(ppb), X, faithful=faithful)
        torch.cuda.synchronize()
        want = schedule_sim.schedule_replay_plain(*kernel_args(ppb), X,
                                                  faithful=faithful)
        same_feas = bool(torch.equal(got[1], want[1]))
        errs = [float((g - w).abs().max()) for g, w in
                ((got[0], want[0]), (got[2], want[2]))]
        rels = [float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                for g, w in ((got[0], want[0]), (got[2], want[2]))]
        rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
        n_feas = int(want[1].sum())
        print(f"[check] {tag}: X {tuple(X.shape)} feasible {n_feas}/"
              f"{want[1].numel()} equal={same_feas} max_abs_err "
              f"total {errs[0]:.3g} tsum {errs[1]:.3g} max_rel_err "
              f"{max(rels):.3g}", flush=True)
        assert same_feas, f"{tag}: feasible differs"
        assert max(rels) <= RTOL, f"{tag}: costs differ beyond rtol {RTOL}"
        assert all(torch.isfinite(t).all() for t in got[::2]), tag

    def deep_bucket():
        """Parents beyond B1's ring of end times: a 300-layer chain with skip
        edges up to 250 steps back and a 150-layer random DAG (parents drawn
        from every earlier layer), beside googlenet, in one bucket."""
        n, m = 300, 150
        edges = [(j, j + 1) for j in range(n - 1)] + [
            (0, 250), (5, 105), (40, 73), (100, 299)]
        redges = [(int(u), j) for j in range(1, m)
                  for u in rng.choice(j, size=min(j, 3), replace=False)]
        dags = [port.LayerDAG(
            compute=rng.uniform(0.1, 3.0, k), edges=np.asarray(e, np.int32),
            edge_mb=rng.uniform(0.05, 2.0, len(e)), app_id=app,
            deadline=dl, pinned=pin)
            for k, e, app, dl, pin in (
                (n, edges, np.zeros(n, np.int32), np.array([1e4]),
                 np.r_[0, np.full(n - 1, -1)].astype(np.int32)),
                (m, redges, (np.arange(m) >= 70).astype(np.int32),
                 np.array([1e3, 2e3]), np.full(m, -1, np.int32)))]
        probs = [port.SimProblem.build(d, env) for d in
                 dags + [port.zoo.build("googlenet", pin_server=1)]]
        return probs, port.pack_problems(probs, device=dev)

    traffic_cfg = port.TrafficConfig(kind="bursty", rate=0.5)

    def traffic_bucket():
        """The bucket the traffic phase solves: the plan bucket under the
        bursty 0.5/s solver draws of ``plan_offload_batch`` (request i
        from seed SEED + 31 i): 3 problems x 48 particles x 32 layers,
        M = 3 draws, R = 8 requests."""
        ppb, X = plan_bucket()
        arr = port.pack_arrivals([traffic_cfg.solver_arrivals(
            1, seed=SEED + 31 * i) for i in range(len(shapes))], 1)
        return ppb, X, port.traffic_inputs(ppb, arr)

    def resnet_traffic():
        """resnet101 (338 layers) x 100 particles under 3 bursty draws of
        R = 8 requests."""
        d = port.zoo.build("resnet101", pin_server=0)
        h, _ = port.heft_makespan(d, env)
        prob = port.SimProblem.build(d.with_deadline(np.array([2.0 * h])),
                                     env)
        ppb = port.stack_problems([port.pad_problem(prob, device=dev)])
        X = torch.as_tensor(random_swarm(rng, prob, 100, prob.num_layers),
                            device=dev)[None]
        arr = port.sample_arrivals("bursty", 1, rate=0.5, n_seeds=3,
                                   seed=SEED).t
        return ppb, X, port.traffic_inputs(ppb, arr[None])

    def tcompare(tag, ppb, X, tin, faithful, grid=True):
        """B2 against its plain version on the same CUDA tensors; with
        ``grid`` both also fill a latency grid (as a held-out replay
        does), without it neither does (as the solver's fitness).
        Returns the plain version's outputs."""
        (N, P), (M, A, R) = X.shape[:2], tin.arr2.shape[1:]
        lat_k, lat_p = (torch.empty((N, M, P, A, R), device=dev)
                        if grid else None for _ in range(2))
        got = b2(*kernel_args(ppb), X, *tin, faithful=faithful,
                      latency=lat_k)
        torch.cuda.synchronize()
        want = traffic_sim.traffic_replay_plain(
            *kernel_args(ppb), X, *tin, faithful=faithful, latency=lat_p)
        same_ok = bool(torch.equal(got[3], want[3]))
        same_miss = bool(torch.equal(got[1], want[1]))
        pairs = [(got[k], want[k]) for k in ((0, 2, 4) if grid else (0, 2))]
        errs = [float((g - w).abs().max()) for g, w in pairs]
        rels = [float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                for g, w in pairs]
        rec["traffic_max_abs_err"] = max(rec["traffic_max_abs_err"], *errs)
        bits = all(torch.equal(g, w) for g, w in pairs)
        lat_err = f"{errs[2]:.3g}" if grid else "(no grid)"
        print(f"[check] B2 {tag}: X {tuple(X.shape)} M {M} R {R} steps "
              f"{tin.n_valid.min().item()}..{tin.n_valid.max().item()} "
              f"static_ok {int(want[3].sum())}/{want[3].numel()} "
              f"equal={same_ok} miss>0 {int((want[1] > 0).sum())}/"
              f"{want[1].numel()} equal={same_miss} max_abs_err total "
              f"{errs[0]:.3g} lat_sum {errs[1]:.3g} latency {lat_err} "
              f"max_rel_err {max(rels):.3g} bit_equal={bits}", flush=True)
        assert same_ok, f"{tag}: static_ok differs"
        assert same_miss, f"{tag}: miss_rate differs"
        assert max(rels) <= RTOL, f"{tag}: beyond rtol {RTOL}"
        assert all(torch.isfinite(g).all() for g, _ in pairs), tag
        return want

    def check_solve_buckets(tag, probs, arrivals, P, plans, faithful):
        """B2 (or, without ``arrivals``, B1) against its plain version at a
        solve's own launches: ``pack_fleet``'s buckets of ``probs`` under
        the solver draws ``arrivals``, P particles, no latency grid. The
        swarm holds each problem's plans from ``plans`` (lists of one plan
        per problem) after two anchors, then seeded random particles."""
        fleet = port.pack_fleet(probs, device=dev)
        for b in fleet.buckets:
            X = np.stack([random_swarm(rng, probs[i], P, b.max_p)
                          for i in b.idx])
            for j, i in enumerate(b.idx):
                for k, plan in enumerate(plans):
                    X[j, 2 + k, :probs[i].num_layers] = plan[i]
            X = torch.as_tensor(X, device=dev)
            where = (f"{tag} solve bucket max_p {b.max_p} problems "
                     f"{b.idx.tolist()}")
            if arrivals is None:
                compare(where, b.ppb, X, faithful)
                continue
            tin = port.traffic_inputs(b.ppb, port.pack_arrivals(
                [arrivals[i] for i in b.idx], fleet.max_apps))
            tcompare(where, b.ppb, X, tin, faithful, grid=False)

    def check_heldout(tag, prob, x, ev, faithful, reported):
        """B2 against its plain version at a held-out replay's launch (one
        plan, every evaluation draw, latency grid), built as
        ``traffic_replay`` builds it; the reported miss tails must be the
        plain replay's."""
        ppb = port.stack_problems([port.pad_problem(prob, device=dev)])
        A = int(ppb.deadline.shape[-1])
        arr = np.full((ev.shape[0], A, ev.shape[2]), np.inf)
        arr[:, :ev.shape[1]] = ev
        X = torch.zeros((1, 1, ppb.max_layers), dtype=torch.int32,
                        device=dev)
        X[0, 0, :len(x)] = torch.as_tensor(x, device=dev)
        want = tcompare(f"{tag} held-out", ppb, X,
                        port.traffic_inputs(ppb, arr[None]), faithful)
        mr = want[1][0, :, 0].cpu().numpy().astype(float)
        for q in (50, 95, 99):
            assert reported[f"miss_p{q}"] == float(np.percentile(mr, q)), \
                (tag, q, reported)

    def check_traffic():
        ppb, X, tin = traffic_bucket()
        for faithful in (True, False):
            tcompare(f"qwen3-0.6b traffic bucket faithful={faithful}", ppb,
                     X, tin, faithful)
        probs = []
        for i, net in enumerate(("alexnet", "googlenet")):
            d = port.merge_dags([port.zoo.build(net, pin_server=2 * i + k)
                                 for k in range(2)])
            hd, _ = port.heft_makespan(d, env)
            probs.append(port.SimProblem.build(
                d.with_deadline(np.full(2, 1.5 * hd)), env))
        ppb = port.pack_problems(probs, device=dev)
        Xb = torch.as_tensor(np.stack([
            random_swarm(rng, pr, 100, ppb.max_layers) for pr in probs]),
            device=dev)
        for kind in port.TRAFFIC_KINDS:
            arrs = [port.sample_arrivals(kind, 2, rate=0.5, n_seeds=3,
                                         seed=SEED + i).t for i in range(2)]
            arrs[0][0, 1] = np.inf          # an app with no request at all
            tin = port.traffic_inputs(ppb, port.pack_arrivals(arrs, 2))
            for faithful in (True, False):
                tcompare(f"alexnet+googlenet bucket {kind} "
                         f"faithful={faithful}", ppb, Xb, tin, faithful)
        # arrivals tied across the two apps of each problem
        arrs = [np.repeat(port.sample_arrivals(
            "bursty", 1, rate=0.5, n_seeds=3, seed=SEED + 7 + i).t, 2, 1)
            for i in range(2)]
        tin = port.traffic_inputs(ppb, port.pack_arrivals(arrs, 2))
        for faithful in (True, False):
            tcompare(f"alexnet+googlenet bucket, arrivals tied across apps, "
                     f"faithful={faithful}", ppb, Xb, tin, faithful)
        ppb, X, tin = resnet_traffic()
        for faithful in (True, False):
            tcompare(f"resnet101 faithful={faithful}", ppb, X, tin, faithful)
        # parents beyond B2's ring of end times (and, across the random
        # DAG's two apps, parents whose requests have not arrived yet)
        probs, ppb = deep_bucket()
        A = int(ppb.deadline.shape[-1])
        tin = port.traffic_inputs(ppb, port.pack_arrivals([
            port.sample_arrivals("bursty", pr.num_apps, rate=0.5, n_seeds=3,
                                 seed=SEED + 11 + i).t
            for i, pr in enumerate(probs)], A))
        meta = traffic_sim.traffic_step_tables(
            ppb.order, ppb.parent_idx, ppb.app_id, tin.slot_m, tin.n_valid,
            tin.arr2.shape[-1])
        far = int((meta[..., 2:] > traffic_sim.RING).sum())
        assert far > 0, "the deep bucket must read beyond B2's ring"
        Xb = torch.as_tensor(np.stack([
            random_swarm(rng, pr, 129, ppb.max_layers) for pr in probs]),
            device=dev)
        for faithful in (True, False):
            tcompare(f"deep bucket, {far} parent reads beyond the ring of "
                     f"{traffic_sim.RING}, faithful={faithful}", ppb, Xb, tin,
                     faithful)

    def check():
        ppb, X = plan_bucket()
        for faithful in (True, False):
            compare(f"qwen3-0.6b plan bucket faithful={faithful}", ppb, X,
                    faithful)
        res_dag = port.zoo.build("resnet101", pin_server=0)
        h, _ = port.heft_makespan(res_dag, env)
        res_prob = port.SimProblem.build(
            res_dag.with_deadline(np.array([2.0 * h])), env)
        pp = port.pad_problem(res_prob, device=dev)
        X = torch.as_tensor(random_swarm(rng, res_prob, 100,
                                         res_prob.num_layers), device=dev)
        for faithful in (True, False):
            compare(f"resnet101 faithful={faithful}",
                    port.stack_problems([pp]), X[None], faithful)
        compare("fig8 corrected", *fig8_bucket(), False)
        fleet = []
        for i, net in enumerate(port.zoo.NAMES * 2):
            d = port.zoo.build(net, pin_server=i)
            hd, _ = port.heft_makespan(d, env)
            fleet.append(port.SimProblem.build(
                d.with_deadline(np.array([(1.5 + 0.5 * i) * hd])), env))
        ppb = port.pack_problems(fleet, device=dev)
        Xb = torch.as_tensor(np.stack([
            random_swarm(rng, pr, 100, ppb.max_layers) for pr in fleet]),
            device=dev)
        for faithful in (True, False):
            compare(f"fleet bucket of 8 faithful={faithful}", ppb, Xb,
                    faithful)
        probs, ppb = deep_bucket()
        meta = schedule_sim.step_tables(ppb.order, ppb.parent_idx,
                                        ppb.app_id)
        far = int((meta[..., 1:] > schedule_sim.RING).sum())
        assert far > 0, "the deep bucket must read beyond the ring"
        Xb = torch.as_tensor(np.stack([
            random_swarm(rng, pr, 129, ppb.max_layers) for pr in probs]),
            device=dev)
        for faithful in (True, False):
            compare(f"deep bucket, {far} parent reads beyond the ring of "
                    f"{schedule_sim.RING}, faithful={faithful}", ppb, Xb,
                    faithful)
        check_traffic()
    _phase("check", check, failures)

    # 3. time -------------------------------------------------------------
    timing = {}

    def cuda_ms(fn, reps):
        """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def queued_ms(fn, reps):
        """Device ms per call of ``fn`` over ``reps`` calls queued behind a
        device sleep, after a warm-up: the host's cost of each call (the
        wrapper's checks, ctypes) overlaps the sleep, not the timed
        stretch. Also the host's ms per call, and whether every call was
        queued before the sleep ended (else the time holds host gaps)."""
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        torch.cuda.synchronize()
        return (ev[1].elapsed_time(ev[2]) / reps, host / reps,
                host < ev[0].elapsed_time(ev[1]))

    def time_kernel():
        max_mhz = float(smi_field("clocks.max.sm"))
        for tag, (ppb, X), reps in (
                ("qwen3-0.6b plan bucket", plan_bucket(), (50, 3)),
                ("fig8", fig8_bucket(), (20, 2))):
            args = kernel_args(ppb)
            k = [queued_ms(lambda: b1(*args, X, faithful=False), reps[0])
                 for _ in range(5)]
            ms = float(np.median([r[0] for r in k]))
            plain = cuda_ms(lambda: schedule_sim.schedule_replay_plain(
                *args, X, faithful=False), reps[1])
            bms, by = bound_ms(ppb, X.shape[1], faithful=False)
            chain = chain_bound_ms(ppb, max_mhz)
            steps = int((ppb.order >= 0).sum(-1).max())
            timing[f"b1 {tag}"] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                       bound_by=by, chain_ms=chain)
            print(f"[time] B1 {tag} corrected X {tuple(X.shape)}, {steps} "
                  f"steps: kernel ms per round "
                  f"{[round(r[0], 5) for r in k]} (host ms per call "
                  f"{float(np.median([r[1] for r in k])):.4f}), median "
                  f"{ms:.4f} ms ({1e6 * ms / steps * max_mhz / 1e3:.1f} "
                  f"cycles a step at {max_mhz:.0f} MHz, SM clock now "
                  f"{smi_field('clocks.sm')} MHz)  plain {plain:.2f} ms  bound "
                  f"{bms:.6f} ms ({by})  chain bound {chain:.4f} ms ({steps} "
                  f"x {CHAIN_CYCLES} cycles: 4 dependent FP32 ops x "
                  f"{FP32_OP_CYCLES}, at the {max_mhz:.0f} MHz maximum SM "
                  f"clock); every call queued ahead of the device: "
                  f"{all(r[2] for r in k)}", flush=True)
        timing.update(timing["b1 fig8"])
        for tag, (ppb, X, tin), reps in (
                ("resnet101", resnet_traffic(), (20, 2)),
                ("qwen3-0.6b traffic bucket", traffic_bucket(), (50, 3))):
            args = kernel_args(ppb)
            k = [queued_ms(lambda: b2(*args, X, *tin, faithful=False),
                           reps[0]) for _ in range(5)]
            ms = float(np.median([r[0] for r in k]))
            plain = cuda_ms(lambda: traffic_sim.traffic_replay_plain(
                *args, X, *tin, faithful=False), reps[1])
            bms, by = traffic_bound_ms(ppb, tin, X.shape[1], faithful=False)
            steps = int(tin.n_valid.max())           # the longest lane
            chain = 1e3 * steps * CHAIN_CYCLES / (max_mhz * 1e6)
            timing[f"traffic {tag}"] = dict(ms=ms, plain_ms=plain,
                                            bound_ms=bms, bound_by=by,
                                            chain_ms=chain)
            print(f"[time] B2 {tag} corrected X {tuple(X.shape)} M "
                  f"{tin.n_valid.shape[1]}, steps {int(tin.n_valid.sum())} "
                  f"(longest lane {steps}): kernel ms per round "
                  f"{[round(r[0], 5) for r in k]} (host ms per call "
                  f"{float(np.median([r[1] for r in k])):.4f}), median "
                  f"{ms:.4f} ms ({1e6 * ms / steps * max_mhz / 1e3:.1f} "
                  f"cycles a step of the longest lane at {max_mhz:.0f} MHz)  "
                  f"plain {plain:.2f} ms  bound {bms:.6f} ms ({by})  chain "
                  f"bound {chain:.4f} ms ({steps} x {CHAIN_CYCLES} cycles); "
                  f"every call queued ahead of the device: "
                  f"{all(r[2] for r in k)}", flush=True)
    _phase("time", time_kernel, failures)

    def replay_ok(tag, dag, env_, res, faithful):
        """The solver's answer, replayed by the numpy oracle."""
        r = port.simulate_np(port.SimProblem.build(dag, env_), res.best_x,
                             faithful=faithful)
        assert bool(r.feasible) == res.feasible, f"{tag}: feasibility"
        assert np.isfinite(res.best_fitness), tag
        if res.feasible:
            np.testing.assert_allclose(res.best_cost, float(r.total_cost),
                                       rtol=ORACLE_RTOL, err_msg=tag)

    # 4. plan: the main path ----------------------------------------------
    launches = {}
    planned = {}            # the plan and traffic phases' cold results

    def plan():
        b1.launches = 0
        t0 = time.perf_counter()
        plans = port.plan_offload_batch(
            [(get("qwen3-0.6b"), s, DEADLINE_RATIO) for s in shapes],
            env=tpu_env, pso=DEFAULT_PSO, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["plan"] = b1.launches
        planned["plan"] = plans
        for shape, p in zip(shapes, plans):
            print(f"[plan] {shape.name}: iterations "
                  f"{p.result.iterations}\n{p.summary()}")
            assert p.backend == "cuda"
            replay_ok(shape.name, p.dag, p.env, p.result,
                      DEFAULT_PSO.faithful_sim)
        print(f"[plan] qwen3-0.6b: {len(plans)} shapes in {wall:.3f} s, "
              f"schedule_replay launches {launches['plan']}", flush=True)
        assert launches["plan"] > 0, "main path never launched the kernel"
    _phase("plan", plan, failures)

    # 5. traffic: the plan under a bursty request stream -------------------
    def traffic():
        b1.launches = 0
        b2.launches = 0
        t0 = time.perf_counter()
        plans = port.plan_offload_batch(
            [(get("qwen3-0.6b"), s, DEADLINE_RATIO) for s in shapes],
            env=tpu_env, pso=DEFAULT_PSO, seed=SEED, traffic=traffic_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["traffic"] = b2.launches
        launches["traffic_zero_load"] = b1.launches
        planned["traffic"] = plans
        for i, (shape, p) in enumerate(zip(shapes, plans)):
            assert p.backend == "cuda"
            # the returned key, replayed through the plain traffic replay
            pp = port.pad_problem(port.SimProblem.build(p.dag, p.env),
                                  device="cpu")
            key = float(port.make_swarm_fitness(
                pp, DEFAULT_PSO.faithful_sim,
                arrivals=traffic_cfg.solver_arrivals(1, seed=SEED + 31 * i),
                miss_budget=traffic_cfg.miss_budget)(
                torch.as_tensor(p.result.best_x[None]))[0])
            tr = p.traffic
            print(f"[traffic] {shape.name}: iterations "
                  f"{p.result.iterations} key {p.result.best_fitness:.8g} "
                  f"(plain replay {key:.8g}); held-out miss p50/p95/p99 "
                  f"{tr['miss_p50']:.4f}/{tr['miss_p95']:.4f}/"
                  f"{tr['miss_p99']:.4f} over {tr['requests']} requests\n"
                  f"{p.summary()}")
            np.testing.assert_allclose(p.result.best_fitness, key,
                                       rtol=RTOL, err_msg=shape.name)
            replay_ok(shape.name, p.dag, p.env, p.result,
                      DEFAULT_PSO.faithful_sim)
        print(f"[traffic] qwen3-0.6b under bursty 0.5/s: {len(plans)} shapes "
              f"in {wall:.3f} s, traffic_replay launches "
              f"{launches['traffic']}, schedule_replay launches "
              f"{launches['traffic_zero_load']}", flush=True)
        assert launches["traffic"] > 0, "traffic path never launched B2"
        # B2 at this phase's own launches, after its counts were read
        probs = [port.SimProblem.build(p.dag, p.env) for p in plans]
        check_solve_buckets(
            "traffic", probs,
            [traffic_cfg.solver_arrivals(p.dag.num_apps, seed=SEED + 31 * i)
             for i, p in enumerate(plans)],
            DEFAULT_PSO.pop_size, [[p.result.best_x for p in plans]],
            DEFAULT_PSO.faithful_sim)
        for i, (shape, p, pr) in enumerate(zip(shapes, plans, probs)):
            check_heldout(f"traffic {shape.name}", pr, p.result.best_x,
                          traffic_cfg.eval_arrivals(p.dag.num_apps,
                                                    seed=SEED + 31 * i),
                          DEFAULT_PSO.faithful_sim, p.traffic)
    _phase("traffic", traffic, failures)

    # 6. fig8 at the paper's settings -------------------------------------
    def fig8():
        cfg = PAPER_PSO
        b1.launches = 0
        t0 = time.perf_counter()
        res = port.run_pso_ga(fig8_dag, fig8_env, cfg, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["fig8"] = b1.launches
        t1 = time.perf_counter()
        greedy = port.greedy_offload(fig8_dag, fig8_env)
        g_wall = time.perf_counter() - t1
        print(f"[fig8] PSO-GA: cost {res.best_cost:.6g} feasible "
              f"{res.feasible} iterations {res.iterations} in "
              f"{1e3 * wall:.1f} ms "
              f"({launches['fig8']} launches); greedy: cost "
              f"{greedy.best_cost:.6g} feasible {greedy.feasible} in "
              f"{g_wall:.2f} s", flush=True)
        replay_ok("fig8", fig8_dag, fig8_env, res, cfg.faithful_sim)
        # the paper's claim at Fig. 8: PSO-GA is no worse than greedy
        assert res.feasible or not greedy.feasible, "greedy feasible, PSO-GA not"
        if res.feasible and greedy.feasible:
            assert res.best_cost <= greedy.best_cost * (1 + RTOL), \
                (res.best_cost, greedy.best_cost)
        # initial scoring + one per loop step + the epilogue
        assert res.iterations + 2 <= launches["fig8"] \
            <= res.iterations + 2 + SYNC_EVERY, launches["fig8"]
    _phase("fig8", fig8, failures)

    # 7. traffic-fleet: traffic-aware against zero-load plans ---------------
    def traffic_fleet():
        cfg = PAPER_PSO
        fleet = []
        for i, net in enumerate(("alexnet", "googlenet")):
            d = port.zoo.build(net, pin_server=i)
            h, _ = port.heft_makespan(d, env)
            fleet.append((d.with_deadline(np.array([1.5 * h])), env))
        probs = [port.SimProblem.build(dag, env) for dag, _ in fleet]
        for kind in ("bursty", "flash-crowd"):
            tc = port.TrafficConfig(kind=kind, rate=0.5,
                                    miss_budget=cfg.miss_budget)
            b1.launches = 0
            b2.launches = 0
            t0 = time.perf_counter()
            zero = port.run_pso_ga_batch(fleet, cfg, seed=SEED)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            solver_arr = [tc.solver_arrivals(1, seed=SEED + 31 * i)
                          for i in range(len(fleet))]
            aware = port.run_pso_ga_batch(fleet, cfg, seed=SEED,
                                          arrivals=solver_arr)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_b2, n_b1 = b2.launches, b1.launches
            print(f"[traffic-fleet] {kind}: zero-load solve {t1 - t0:.2f} s, "
                  f"traffic-aware solve {t2 - t1:.2f} s, traffic_replay "
                  f"launches {n_b2}, schedule_replay launches {n_b1}",
                  flush=True)
            assert n_b2 > 0
            # B2 at the traffic-aware solve's own launches
            check_solve_buckets(f"traffic-fleet {kind}", probs, solver_arr,
                                cfg.pop_size,
                                [[r.best_x for r in res] for res in (zero,
                                                                     aware)],
                                cfg.faithful_sim)
            for i, prob in enumerate(probs):
                ev = tc.eval_arrivals(1, seed=SEED + 31 * i)
                st = {name: port.traffic_stats(port.traffic_replay(
                    prob, res[i].best_x, ev, faithful=cfg.faithful_sim))
                    for name, res in (("zero", zero), ("aware", aware))}
                for name, res in (("zero", zero), ("aware", aware)):
                    check_heldout(f"traffic-fleet {kind} {name} {i}", prob,
                                  res[i].best_x, ev, cfg.faithful_sim,
                                  st[name])
                print(f"[traffic-fleet] {kind} {('alexnet', 'googlenet')[i]}"
                      f": held-out miss p50/p95/p99 zero-load "
                      f"{st['zero']['miss_p50']:.4f}/"
                      f"{st['zero']['miss_p95']:.4f}/"
                      f"{st['zero']['miss_p99']:.4f} (load cost "
                      f"${st['zero']['cost_mean']:.6f}, {zero[i].iterations}"
                      f" iterations) traffic-aware "
                      f"{st['aware']['miss_p50']:.4f}/"
                      f"{st['aware']['miss_p95']:.4f}/"
                      f"{st['aware']['miss_p99']:.4f} (load cost "
                      f"${st['aware']['cost_mean']:.6f}, "
                      f"{aware[i].iterations} iterations, key "
                      f"{aware[i].best_fitness:.6g})", flush=True)
                replay_ok(f"{kind} aware {i}", fleet[i][0], env, aware[i],
                          cfg.faithful_sim)
                assert st["aware"]["miss_p95"] <= st["zero"]["miss_p95"], \
                    (kind, i, st)
    _phase("traffic-fleet", traffic_fleet, failures)

    def own_swarm(prob, P, winners):
        """A seeded swarm of P particles at ``prob``'s own size (the shape
        ``run_ga`` / ``run_pso_linear`` / ``pre_pso`` solve at), holding
        the solvers' winning plans after two anchors; leading axis 1."""
        X = random_swarm(rng, prob, P, prob.num_layers)
        for k, res in enumerate(winners):
            X[2 + k] = res.best_x
        return torch.as_tensor(X[None], device=dev)

    # 8. baselines: the paper's comparators at the Fig. 8 size -------------
    def baselines():
        ga_cfg = port.GAConfig()              # pop 100, <= 1000, stall 50
        t0 = time.perf_counter()
        small, _ = port.preprocess(fig8_dag)
        print(f"[baselines] Alg. 1 preprocessing on the host (prePSO's "
              f"first step): {fig8_prob.num_layers} -> {small.num_layers} "
              f"layers in {1e3 * (time.perf_counter() - t0):.1f} ms",
              flush=True)
        winners = []
        for name, fn, cfg in (("GA", port.run_ga, ga_cfg),
                              ("PSO (linear inertia)", port.run_pso_linear,
                               PAPER_PSO),
                              ("prePSO", port.pre_pso, PAPER_PSO)):
            b1.launches = 0
            b2.launches = 0
            t0 = time.perf_counter()
            res = fn(fig8_dag, fig8_env, cfg, seed=SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n1, n2 = b1.launches, b2.launches
            ok = port.simulate_np(fig8_prob, res.best_x,
                                  faithful=cfg.faithful_sim)
            print(f"[baselines] {name}: cost {res.best_cost:.6g} feasible "
                  f"{res.feasible} iterations {res.iterations} in "
                  f"{1e3 * wall:.1f} ms, schedule_replay launches {n1}, "
                  f"traffic_replay launches {n2}; simulate_np cost "
                  f"{float(ok.total_cost):.6g} feasible {bool(ok.feasible)}",
                  flush=True)
            replay_ok(f"baselines {name}", fig8_dag, fig8_env, res,
                      cfg.faithful_sim)
            # the first scoring, one per step (the loop checks its stop
            # rule every SYNC_EVERY steps), and the epilogue's one-row
            # replay; prePSO solves the compressed DAG the same way
            assert res.iterations + 2 <= n1 \
                <= res.iterations + 2 + SYNC_EVERY, (name, n1)
            assert n2 == 0, name
            winners.append(res)
        # B1 against its plain version at the solves' own shape
        compare("baselines: fig8 swarm holding the GA, PSO and prePSO plans",
                port.stack_problems([port.pad_problem(fig8_prob,
                                                      device=dev)]),
                own_swarm(fig8_prob, ga_cfg.pop_size, winners),
                ga_cfg.faithful_sim)
        # the GA under the traffic key: B2 on the traffic-fleet problems
        tc = port.TrafficConfig(kind="bursty", rate=0.5,
                                miss_budget=ga_cfg.miss_budget)
        for i, net in enumerate(("alexnet", "googlenet")):
            d = port.zoo.build(net, pin_server=i)
            h, _ = port.heft_makespan(d, env)
            d = d.with_deadline(np.array([1.5 * h]))
            prob = port.SimProblem.build(d, env)
            arr = tc.solver_arrivals(1, seed=SEED + 31 * i)
            b1.launches = 0
            b2.launches = 0
            t0 = time.perf_counter()
            res = port.run_ga(d, env, ga_cfg, seed=SEED, arrivals=arr)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n1, n2 = b1.launches, b2.launches
            key = float(port.make_swarm_fitness(
                port.pad_problem(prob, device="cpu"), ga_cfg.faithful_sim,
                arrivals=arr, miss_budget=ga_cfg.miss_budget)(
                torch.as_tensor(res.best_x[None]))[0])
            print(f"[baselines] GA under bursty 0.5/s, {net}: key "
                  f"{res.best_fitness:.8g} (plain replay {key:.8g}) "
                  f"iterations {res.iterations} in {1e3 * wall:.1f} ms, "
                  f"traffic_replay launches {n2}, schedule_replay launches "
                  f"{n1}", flush=True)
            np.testing.assert_allclose(res.best_fitness, key, rtol=RTOL,
                                       err_msg=net)
            assert n2 > 0 and res.iterations + 1 <= n2 \
                <= res.iterations + SYNC_EVERY, (net, n2)
            assert n1 == 1, (net, n1)          # the epilogue's replay
            replay_ok(f"GA traffic {net}", d, env, res, ga_cfg.faithful_sim)
            # B2 against its plain version at the GA's own shape and draws
            ppb = port.stack_problems([port.pad_problem(prob, device=dev)])
            tcompare(f"GA traffic {net}", ppb,
                     own_swarm(prob, ga_cfg.pop_size, [res]),
                     port.traffic_inputs(ppb, arr[None]),
                     ga_cfg.faithful_sim, grid=False)
    _phase("baselines", baselines, failures)

    # 9. replan: warm re-planning of the qwen3-0.6b plans -------------------
    def replan():
        requests = [(get("qwen3-0.6b"), s, DEADLINE_RATIO) for s in shapes]
        cold = port.plan_offload_batch(requests, env=tpu_env,
                                       pso=DEFAULT_PSO, seed=SEED)
        cold_t = port.plan_offload_batch(requests, env=tpu_env,
                                         pso=DEFAULT_PSO, seed=SEED,
                                         traffic=traffic_cfg)
        dags = [p.dag for p in cold]
        # a zero-drift round keeps every plan, its key its cold key
        rep = port.replan_fleet(
            dags, port.zero_drift_trace(tpu_env, rounds=2),
            port.ReplanConfig(pso=DEFAULT_PSO),
            initial=[p.result for p in cold])
        (log,) = rep.rounds
        print(f"[replan] zero-drift: {int(log.replanned.sum())}/3 plans "
              f"changed, incumbent keys {log.incumbent_key.tolist()}, "
              f"cold keys {[p.result.best_fitness for p in cold]}",
              flush=True)
        assert not log.replanned.any() and not log.demoted.any()
        for p, x, k in zip(cold, rep.plans, log.incumbent_key):
            assert np.array_equal(x, p.result.best_x)
            assert k == p.result.best_fitness, (k, p.result.best_fitness)
        for scenario, tc, plans0 in (("congestion", None, cold),
                                     ("node-loss", None, cold),
                                     ("load-surge", traffic_cfg, cold_t)):
            trace = port.sample_trace(scenario, tpu_env, rounds=4, seed=0)
            pso = DEFAULT_PSO if tc is None else dataclasses.replace(
                DEFAULT_PSO, miss_budget=tc.miss_budget)
            cfg = port.ReplanConfig(pso=pso, traffic=tc)
            rounds = []

            def on_round(log, plans):
                n1, n2 = b1.launches, b2.launches
                rounds.append((log, plans, n1, n2))
                print(f"[replan] {scenario} round {log.round} ({log.label})"
                      f": {int(log.replanned.sum())}/{len(plans)} plans "
                      f"changed (demoted {int(log.demoted.sum())}), fleet "
                      f"cost ${float(np.sum(log.cost)):.6f}, moved layers "
                      f"{log.moved_layers.tolist()}, iterations "
                      f"{log.iterations.tolist()}, {1e3 * log.wall_s:.1f} "
                      f"ms, schedule_replay launches {n1}, traffic_replay "
                      f"launches {n2}", flush=True)
                b1.launches = 0
                b2.launches = 0
            b1.launches = 0
            b2.launches = 0
            rep = port.replan_fleet(dags, trace, cfg,
                                    initial=[p.result for p in plans0],
                                    on_round=on_round)
            for k, (log, plans, n1, n2) in enumerate(rounds, start=1):
                acc = log.replanned & ~log.demoted
                assert (log.candidate_key[acc]
                        < log.incumbent_key[acc]).all(), (scenario, k)
                down = trace.events[k].down
                for i in np.flatnonzero(log.replanned):
                    assert not down[plans[i]].any(), (scenario, k, i)
                # one B1 (or B2) launch for the incumbent keys, then per
                # bucket the solve's and its epilogue's
                assert (n2 if tc is not None else n1) \
                    >= int(log.iterations.max()) + 2, (scenario, k, n1, n2)
                assert n1 > 0 and (n2 > 0) == (tc is not None)
            last = rep.rounds[-1]
            env_k = trace.env_at(trace.num_rounds - 1)
            probs = [port.SimProblem.build(d, env_k) for d in dags]
            for i, (pr, x) in enumerate(zip(probs, rep.plans)):
                r = port.simulate_np(pr, x, faithful=pso.faithful_sim)
                assert np.isfinite(float(r.total_cost)), (scenario, i)
                if tc is None:
                    assert bool(r.feasible) == last.feasible[i], (scenario, i)
                    if last.feasible[i]:
                        np.testing.assert_allclose(
                            last.cost[i], float(r.total_cost),
                            rtol=ORACLE_RTOL, err_msg=f"{scenario} {i}")
            # the replay kernels against their plain versions at the last
            # round's buckets, the surviving plans in the swarm
            k = trace.num_rounds - 1
            arrivals = None if tc is None else [
                tc.solver_arrivals(d.num_apps, seed=1000 * k + 31 * i,
                                   rate_scale=trace.events[k].load_scale)
                for i, d in enumerate(dags)]
            check_solve_buckets(f"replan {scenario}", probs, arrivals,
                                pso.pop_size, [rep.plans], pso.faithful_sim)
    _phase("replan", replan, failures)

    # 10. service: the always-on planning service on the qwen3-0.6b plans --
    def service():
        from repro_torch.core.service import _down_env, _plan_ok
        from repro_torch.launch.breakdown import profile
        from repro_torch.launch.plan import chaos_script
        plans0, plans_t = planned["plan"], planned["traffic"]
        dags = [p.dag for p in plans0]
        rcfg = port.ReplanConfig(pso=DEFAULT_PSO)
        pso_t = dataclasses.replace(DEFAULT_PSO,
                                    miss_budget=traffic_cfg.miss_budget)
        rcfg_t = port.ReplanConfig(pso=pso_t, traffic=traffic_cfg)

        def run(tag, trace, cfg, initial, **kw):
            """One counted service run: B1 and B2 launches per round."""
            rows = []

            def on_round(log, plans):
                rows.append((log, [None if x is None else np.array(x)
                                   for x in plans], b1.launches,
                             b2.launches))
                print(f"[service] {tag} round {log.round} ({log.label}): "
                      f"rungs {list(log.rung)}, breaker "
                      f"{log.breaker_state}, {1e3 * log.wall_s:.1f} ms, "
                      f"budget {log.budget_iters:.4g} iterations, "
                      f"schedule_replay launches {b1.launches}, "
                      f"traffic_replay launches {b2.launches}"
                      + "".join(f" [{f}]" for f, on in (
                          ("stale-env", log.stale_env),
                          ("solver-failed", log.solver_failed),
                          ("cache-hit", log.cache_hit)) if on),
                      flush=True)
                b1.launches = 0
                b2.launches = 0
            b1.launches = 0
            b2.launches = 0
            rep = port.run_service(
                dags, trace, cfg, seed=SEED, on_round=on_round,
                initial=None if initial is None
                else [p.result for p in initial], sleeper=lambda s: None,
                **kw)
            s = rep.summary()
            print(f"[service] {tag}: availability {s['availability']:.4f}, "
                  f"time to plan p50 {1e3 * s['time_to_plan_s']['p50']:.1f}"
                  f" ms p99 {1e3 * s['time_to_plan_s']['p99']:.1f} ms, "
                  f"fallbacks {s['fallback_counts']}, counters "
                  f"{s['counters']}, cache {rep.cache_stats}", flush=True)
            return rep, rows

        # (a) congestion under --chaos's faults, with the plan cache
        trace = port.sample_trace("congestion", tpu_env, rounds=6, seed=0)
        chaos = chaos_script(6)
        rep, rows = run("chaos", trace, port.ServiceConfig(
            replan=rcfg, chaos=chaos, plan_cache=port.PlanCacheConfig()),
            plans0)
        assert rep.counters["stale_env_rounds"] == 1, rep.counters
        assert rep.counters["crashes"] + rep.counters["retries"] >= 1
        good = trace.env_at(0)
        for log, plans, n1, n2 in rows:
            env_k = good if log.stale_env else trace.env_at(log.round)
            good = env_k
            if log.round in chaos.mid_round_down:
                env_k = _down_env(env_k, chaos.mid_round_down[log.round])
            for d, x in zip(dags, plans):
                assert _plan_ok(port.SimProblem.build(d, env_k), x), \
                    (log.round, log.rung)
            if log.replan is not None:
                assert n1 > 0, log.round
        assert rep.availability() == 1.0

        # (b) zero drift with the plan cache: repeat rounds hit, bit for bit
        rep, rows = run("zero-drift", port.zero_drift_trace(tpu_env, 4),
                        port.ServiceConfig(
                            replan=rcfg, plan_cache=port.PlanCacheConfig()),
                        plans0)
        assert not rep.rounds[0].cache_hit
        for log, plans, n1, n2 in rows[1:]:
            assert log.cache_hit and set(log.rung) == {"cached"}
            assert n1 == 0 and n2 == 0
            for p, x in zip(plans0, plans):
                assert np.array_equal(x, p.result.best_x)

        # (c) --serve bursty: the request stream through a load-surge
        # trace, rates estimated from queued observations
        trace = port.sample_trace("load-surge", tpu_env, rounds=6, seed=0)
        for threads in (0, 2):
            rep, rows = run(f"bursty ingest threads={threads}", trace,
                            port.ServiceConfig(
                                replan=rcfg_t, estimate_rates=True,
                                ingest=port.IngestConfig(threads=threads)),
                            plans_t)
            c = rep.counters
            offered = (trace.num_rounds - 1) * len(dags)
            assert c["ingest_enqueued"] + c["ingest_dropped"] == offered, c
            assert sum(r[3] for r in rows) > 0, "no B2 launch"
            print(f"[service] bursty threads={threads}: estimated rates "
                  f"{[r.est_rates for r in rep.rounds]}", flush=True)

        # (d) two services on threads, one shared cache and telemetry
        trace = port.sample_trace("congestion", tpu_env, rounds=4, seed=0)
        cfg = port.ServiceConfig(replan=rcfg,
                                 plan_cache=port.PlanCacheConfig())
        cache, tel = port.PlanCache(), port.Telemetry()
        b1.launches = 0
        t0 = time.perf_counter()
        reports = port.run_services([dags, dags], trace, cfg, seeds=SEED,
                                    plan_cache=cache, telemetry=tel)
        wall = time.perf_counter() - t0
        n1 = b1.launches
        t0 = time.perf_counter()
        solo, _ = run("solo", trace, cfg, None)
        solo_wall = time.perf_counter() - t0
        for j, r in enumerate(reports):
            for x, y in zip(r.plans, solo.plans):
                assert np.array_equal(x, y), j
            for a, b in zip(r.rounds, solo.rounds):
                assert set(a.rung) <= {"cached"} | set(b.rung), (a, b)
        with tempfile.TemporaryDirectory() as out:
            path, mdir = Path(out) / "trace.json", Path(out) / "metrics"
            tel.export_trace(str(path))
            tel.export_metrics(str(mdir))
            chk = subprocess.run(
                [sys.executable, str(ROOT / "scripts" / "check_trace.py"),
                 str(path), "--metrics", str(mdir), "--require",
                 "round,solve,cache_lookup,ladder,replan_round,fleet_solve,"
                 "cold_solve"], capture_output=True, text=True, timeout=120)
        print(chk.stdout.strip(), flush=True)
        assert chk.returncode == 0, chk.stdout + chk.stderr
        print(f"[service] run_services x2 (shared cache, telemetry): "
              f"{wall:.3f} s against {solo_wall:.3f} s for one service "
              f"alone ({wall / solo_wall:.2f}x), schedule_replay launches "
              f"{n1}, cache "
              f"{cache.stats()}, rungs "
              f"{[[r.rung for r in rep.rounds] for rep in reports]}",
              flush=True)
        assert n1 > 0

        # (e) telemetry on against off, then one profiled run
        trace = port.sample_trace("congestion", tpu_env, rounds=4, seed=0)
        walls = {}
        for tag in ("off", "on", "on", "off"):
            tel = port.Telemetry() if tag == "on" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = port.run_service(dags, trace, port.ServiceConfig(
                replan=rcfg), seed=SEED, telemetry=tel,
                initial=[p.result for p in plans0])
            walls.setdefault(tag, []).append(
                (time.perf_counter() - t0,
                 [round(1e3 * x.wall_s, 2) for x in r.rounds]))
            walls.setdefault(f"plans {tag}", r.plans)
        for x, y in zip(walls["plans on"], walls["plans off"]):
            assert np.array_equal(x, y)
        print(f"[service] telemetry off / on / on / off: wall s and round "
              f"ms {walls['off'][0]} / {walls['on'][0]} / {walls['on'][1]}"
              f" / {walls['off'][1]}", flush=True)
        prof = profile("service-congestion", lambda: port.run_service(
            dags, trace, port.ServiceConfig(replan=rcfg), seed=SEED,
            initial=[p.result for p in plans0]), None)
        prof.pop("top")
        print(f"[service] profiled: {json.dumps(prof)}", flush=True)
    _phase("service", service, failures)

    # 10b. mesh: every solve sharded over a device mesh ----------------------
    def same_results(tag, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g.best_x, w.best_x), (tag, i)
            assert (g.best_fitness, g.best_cost, g.iterations, g.feasible) \
                == (w.best_fitness, w.best_cost, w.iterations,
                    w.feasible), (tag, i)
        assert len(got) == len(want), tag

    def mesh_phase():
        import torch.distributed as dist

        from repro_torch.launch.mesh import resolve_mesh
        from repro_torch.launch.plan import chaos_script
        mesh = resolve_mesh("host")              # a world of one, nccl
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        print(f"[mesh] solver mesh: "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{mesh.size()} devices ({dist.get_backend()})", flush=True)
        requests = [(get("qwen3-0.6b"), s, DEADLINE_RATIO) for s in shapes]

        def both(tag, solve, check):
            """``solve(mesh)`` in turns with ``--mesh none`` and ``host``
            (none, host, host, none): each result ``check``-ed against the
            first, its (B1, B2) launches equal; walls printed. Returns the
            first result."""
            runs = []
            for name in ("none", "host", "host", "none"):
                b1.launches = b2.launches = 0
                t0 = time.perf_counter()
                out = solve(mesh if name == "host" else None)
                torch.cuda.synchronize()
                runs.append((name, out, (b1.launches, b2.launches),
                             1e3 * (time.perf_counter() - t0)))
            for name, out, n, _ in runs[1:]:
                check(out, runs[0][1])
                assert n == runs[0][2], (tag, name, n, runs[0][2])
            walls = {k: [round(w, 1) for nm, _, _, w in runs if nm == k]
                     for k in ("none", "host")}
            print(f"[mesh] {tag}: walls --mesh none {walls['none']} ms, "
                  f"--mesh host {walls['host']} ms (in turns: none, host, "
                  f"host, none); launches B1 {runs[0][2][0]} B2 "
                  f"{runs[0][2][1]} each", flush=True)
            return runs[0][1]

        for tag, tc in (("plan", None), ("traffic", traffic_cfg)):
            def check(got, want, tag=tag):
                same_results(tag, [p.result for p in got],
                             [p.result for p in want])
                assert [p.traffic for p in got] == [p.traffic for p in want]
            none = both(tag, lambda m: port.plan_offload_batch(
                requests, env=tpu_env, pso=DEFAULT_PSO, seed=SEED,
                traffic=tc, mesh=m), check)
            same_results(f"{tag} vs phase {tag}", [p.result for p in none],
                         [p.result for p in planned[tag]])
        both("fig8", lambda m: port.run_pso_ga_batch(
            [(fig8_dag, fig8_env)], PAPER_PSO, seed=SEED, mesh=m),
            lambda got, want: same_results("fig8", got, want))
        cold = planned["plan"]
        dags = [p.dag for p in cold]
        trace = port.sample_trace("congestion", tpu_env, rounds=2, seed=0)

        def same_replan(got, want):
            for x, y in zip(got.plans, want.plans):
                assert np.array_equal(x, y)
            for f in ("replanned", "incumbent_key", "candidate_key", "cost",
                      "iterations", "moved_layers", "demoted"):
                assert np.array_equal(getattr(got.rounds[0], f),
                                      getattr(want.rounds[0], f)), f
        both("replan congestion round 1", lambda m: port.replan_fleet(
            dags, trace, port.ReplanConfig(pso=DEFAULT_PSO, mesh=m),
            initial=[p.result for p in cold]), same_replan)
        strace = port.sample_trace("congestion", tpu_env, rounds=3, seed=0)

        def serve(m):
            per_round = []

            def on_round(r, _plans):
                per_round.append((r.rung, round(1e3 * r.wall_s, 1),
                                  b1.launches, b2.launches))
            scfg = port.ServiceConfig(
                replan=port.ReplanConfig(pso=DEFAULT_PSO, mesh=m),
                chaos=chaos_script(3))
            rep = port.run_service(dags, strace, scfg, seed=SEED,
                                   initial=[p.result for p in cold],
                                   sleeper=lambda s: None, on_round=on_round)
            print(f"[mesh] service --mesh {'none' if m is None else 'host'}"
                  f" per round (rungs, wall ms, cumulative B1, B2): "
                  f"{per_round}", flush=True)
            return rep, [(g, n1, n2) for g, _, n1, n2 in per_round]

        def same_service(got, want):
            (rg, pg), (rw, pw) = got, want
            assert pg == pw, (pg, pw)
            assert rg.counters == rw.counters
            assert rw.counters["crashes"] + rw.counters["retries"] > 0
            for x, y in zip(rg.plans, rw.plans):
                assert np.array_equal(x, y)
        both("service congestion --chaos, 3 rounds", serve, same_service)
        # (b) two ranks over gloo, both on this card, elastic_mesh(model=1):
        # the 3-problem bucket padded to 4 rows, 2 a rank
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 str(r), tmp], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(2)]
            try:
                logs = [p.communicate(timeout=600)[0] for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for r, (p, log) in enumerate(zip(procs, logs)):
                print(log.rstrip(), flush=True)
                assert p.returncode == 0, f"rank {r} failed"
            for r in range(2):
                got = np.load(f"{tmp}/rank{r}.npz")
                for tag in ("plan", "traffic"):
                    for i, w in enumerate(planned[tag]):
                        w = w.result
                        assert np.array_equal(got[f"{tag}.x{i}"], w.best_x)
                        assert (float(got[f"{tag}.fit"][i]),
                                float(got[f"{tag}.cost"][i]),
                                int(got[f"{tag}.it"][i]),
                                bool(got[f"{tag}.feas"][i])) == (
                            w.best_fitness, w.best_cost, w.iterations,
                            w.feasible), (r, tag, i)
        print("[mesh] two gloo ranks on cuda:0: the plan and the traffic "
              "plan equal --mesh none bit for bit on both ranks", flush=True)
    _phase("mesh", mesh_phase, failures)

    # 11. check-attn: B3 and B4 against their plain versions ----------------
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.breakdown import (SERVE_BATCH, SERVE_NEW,
                                              SERVE_PROMPT)
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.serve import Server, request_batch
    from repro_torch.models import CROSS_FRAMES, build_model
    b3, b4 = fa.flash_attention_folded, da.decode_attention_folded
    b5 = ssd_scan.ssd_intra_folded
    qwen, mamba2, zamba2 = (get(a) for a in ("qwen3-0.6b", "mamba2-2.7b",
                                              "zamba2-7b"))
    gemma3, mixtral, arctic, internvl2, whisper = (get(a) for a in (
        "gemma3-27b", "mixtral-8x7b", "arctic-480b", "internvl2-2b",
        "whisper-medium"))
    gemma7, starcoder2 = get("gemma-7b"), get("starcoder2-3b")
    H, KV, HD = qwen.n_heads, qwen.n_kv_heads, qwen.head_dim
    G = H // KV
    serve_cache = SERVE_PROMPT + SERVE_NEW
    gen = torch.Generator(device=dev)
    rec.update(flash_max_abs_err=0.0, decode_max_abs_err=0.0,
               decode_lse_max_abs_err=0.0)

    def randn(shape, dtype, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def attn_check(kind, tag, got, want, dtype):
        """Kernel output against the plain version: every element within
        tol + tol * |want| (the reference tests' allclose), all finite."""
        tol = ATTN_TOL[dtype]
        err = (got.float() - want.float()).abs()
        n_bad = int((err > tol + tol * want.float().abs()).sum())
        mx = float(err.max())
        rec[f"{kind}_max_abs_err"] = max(rec[f"{kind}_max_abs_err"], mx)
        print(f"[check-attn] {kind} {tag} {str(dtype)[6:]}: max_abs_err "
              f"{mx:.3g} (tol {tol:g}) outside {n_bad}", flush=True)
        assert bool(torch.isfinite(got).all()), tag
        assert n_bad == 0, f"{kind} {tag}: {n_bad} elements beyond tol {tol}"

    def check_attn():
        g7kv, g7hd = gemma7.n_kv_heads, gemma7.head_dim
        g7g = gemma7.n_heads // g7kv
        s2kv, s2hd = starcoder2.n_kv_heads, starcoder2.head_dim
        s2g = starcoder2.n_heads // s2kv
        gkv, ghd = gemma3.n_kv_heads, gemma3.head_dim
        gg, wkv = gemma3.n_heads // gkv, whisper.n_kv_heads
        flash_cases = [(shape, True, w, tag) for shape, w, tag in [
            ((SERVE_BATCH, SERVE_PROMPT, KV, G, HD), 0, "qwen3 serve"),
            ((2, SERVE_PROMPT, KV, G, HD), 512, "qwen3 window 512"),
            ((1, 300, 1, 4, 64), 0, "ragged"), ((2, 257, 2, 1, 128), 64,
                                                 "ragged window"),
            ((1, 512, 4, 2, 64), 64, "multi-tile window"),
            ((2, 200, 2, 2, 16), 0, "hd 16"), ((1, 100, 2, 3, 256), 7,
                                               "hd 256 window"),
            ((SERVE_BATCH, SERVE_PROMPT, 32, 1, 112), 0, "zamba2 serve"),
            ((2, 300, 2, 2, 112), 64, "hd 112 ragged window"),
            ((SERVE_BATCH, SERVE_PROMPT, gkv, gg, ghd), gemma3.window,
             "gemma3 local serve"),
            ((SERVE_BATCH, CROSS_FRAMES // 8, wkv, 1, 64), 0,
             "whisper decoder serve")]] + [
            ((SERVE_BATCH, CROSS_FRAMES, wkv, 1, 64), False, 0,
             "whisper encoder serve (bidirectional)")] + [
            # the edges of the wgmma route's 128-row q and kv tiles
            ((1, 1, 2, 2, 128), True, 0, "one token"),
            ((2, 17, 2, 2, 64), True, 0, "seq inside a q tile"),
            ((1, 256, 2, 2, 128), True, 0, "seq of whole tiles"),
            ((1, 300, 2, 2, 128), True, 7, "window inside a kv tile"),
            ((1, 300, 2, 3, 128), True, 0, "G 3"),
            ((1, 300, 1, 4, 128), True, 0, "G 4"),
            ((2, 129, 2, 1, 64), False, 0, "a row past a tile"),
            ((1, 129, 2, 2, 112), True, 0, "hd 112 a row past a tile"),
            # gemma-7b's and starcoder2-3b's prefills, and the edges of the
            # head_dim-256 wgmma route's 80-row kv tiles
            ((SERVE_BATCH, SERVE_PROMPT, g7kv, g7g, g7hd), True, 0,
             "gemma-7b serve"),
            ((SERVE_BATCH, SERVE_PROMPT, s2kv, s2g, s2hd), True, 0,
             "starcoder2-3b serve"),
            ((1, 1, 2, 2, 256), True, 0, "hd 256 one token"),
            ((1, 129, 2, 2, 256), True, 0, "hd 256 a row past a q tile"),
            ((1, 700, 1, 2, 256), True, 100, "hd 256 window 100")]
        # (shape, valid, tag, B4's grid: None for the default)
        decode_cases = [
            ((SERVE_BATCH, serve_cache, KV, G, HD), v, f"qwen3 valid {v}",
             None) for v in (1, 7, 1000, SERVE_PROMPT, serve_cache)] + [
            (*case, None) for case in [
            ((1, 600, 1, 1, 128), 520, "one row, 520 of 600 slots"),
            ((2, 100, 1, 8, 64), 1, "G 8 single slot"),
            ((1, 1000, 2, 2, 64), 999, "ragged"),
            ((1, 64, 2, 3, 16), 64, "hd 16 G 3 full"),
            ((1, 300, 1, 1, 256), 77, "hd 256")] + [
            ((SERVE_BATCH, serve_cache, 32, 1, 112), v, f"zamba2 valid {v}")
            for v in (1, SERVE_PROMPT + 1, serve_cache - 1)] + [
            ((2, 100, 2, 3, 112), 77, "hd 112 G 3"),
            ((SERVE_BATCH, gemma3.window, gkv, gg, ghd), gemma3.window,
             "gemma3 full ring"),
            ((SERVE_BATCH, CROSS_FRAMES + SERVE_NEW, wkv, 1, 64),
             CROSS_FRAMES + 1, "whisper self cache"),
            ((SERVE_BATCH, CROSS_FRAMES + SERVE_NEW, wkv, 1, 64),
             CROSS_FRAMES + SERVE_NEW, "whisper self cache full"),
            # B4's split and tiles at their edges
            ((1, 4000, 1, 2, 128), 4000, "one row over many blocks"),
            ((2, 600, 2, 2, 128), 1, "valid 1, three warps empty"),
            ((2, 300, 2, 3, 128), 250, "G 3"),
            ((2, 300, 1, 12, 64), 299, "G 12, two head groups"),
            ((2, 1000, 2, 2, 16), 777, "hd 16, 256-slot tiles"),
            ((2, 300, 2, 2, 256), 250, "hd 256, G 2"),
            ((SERVE_BATCH, serve_cache, g7kv, g7g, g7hd), SERVE_PROMPT,
             "gemma-7b serve"),
            ((SERVE_BATCH, serve_cache, s2kv, s2g, s2hd), SERVE_PROMPT,
             "starcoder2-3b serve (G 12)")]] + [
            ((3, 300, 2, 2, 64), 200, "ranges across rows", 5),
            ((2, 600, 2, 2, 128), 20, "valid inside the first tile", 3),
            ((2, 300, 1, 8, 64), 299, "G 8, a forced grid", 7)]

        def check_decode(i, b, c, kh, g, hd, valid, tag, blocks, dtype):
            """One B4 case, without and with ``return_lse`` (the output
            bit for bit the same)."""
            q = randn((b, kh, g, hd), dtype, 100 + 3 * i)
            k = randn((b, c, kh, hd), dtype, 101 + 3 * i)
            v = randn((b, c, kh, hd), dtype, 102 + 3 * i)
            k[:, valid:] = 1e9                     # dead slots
            v[:, valid:] = -1e9
            kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
            got = b4(q, kf, vf, valid, blocks=blocks)
            got2, lse = b4(q, kf, vf, valid, blocks=blocks, return_lse=True)
            torch.cuda.synchronize()
            want, want_lse = decode_plain(q, k, v, valid, True)
            grid = "" if blocks is None else f" blocks {blocks}"
            attn_check("decode", f"{tag} {(b, c, kh, g, hd)}{grid}", got,
                       want, dtype)
            assert torch.equal(got, got2), f"{tag}: the lse changed o"
            err = (lse - want_lse).abs()
            bad = int((err > LSE_TOL + LSE_TOL * want_lse.abs()).sum())
            rec["decode_lse_max_abs_err"] = max(
                rec["decode_lse_max_abs_err"], float(err.max()))
            print(f"[check-attn] decode lse {tag} {str(dtype)[6:]}: "
                  f"max_abs_err {float(err.max()):.3g} (tol {LSE_TOL:g})"
                  f" outside {bad}", flush=True)
            assert bad == 0 and bool(torch.isfinite(lse).all()), tag

        for dtype in (torch.float32, torch.bfloat16):
            for i, ((b, s, kh, g, hd), causal, window, tag) in enumerate(
                    flash_cases):
                q = randn((b, s, kh, g, hd), dtype, 3 * i)
                k = randn((b, s, kh, hd), dtype, 3 * i + 1)
                v = randn((b, s, kh, hd), dtype, 3 * i + 2)
                got = ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
                torch.cuda.synchronize()
                want = flash_plain(q, k, v, causal, window)
                attn_check("flash", f"{tag} {(b, s, kh, g, hd)} causal "
                           f"{causal} window {window}", got, want, dtype)
                del want
            for i, case in enumerate(decode_cases):
                check_decode(i, *case[0], *case[1:], dtype)
        # B4's log-sum-exp output (sequence-parallel decode) at a rank's
        # slice of the batch-1 caches: qwen3's 1,040 of 2,080 slots,
        # zamba2's, half of gemma3's ring of 1,024, and qwen3's 8,200 slots
        # a card of four at 32,768; valid lengths ending inside a tile
        half = (SEQ_PROMPT + SEQ_NEW) // 2
        zkv, zhd = zamba2.n_kv_heads, zamba2.head_dim
        lse_cases = [((1, half, KV, G, HD), v, f"qwen3 slice valid {v}")
                     for v in (1, 1000, half)] + [
            ((1, half, zkv, zamba2.n_heads // zkv, zhd), 777,
             "zamba2 slice valid 777"),
            ((1, gemma3.window // 2, gkv, gg, ghd), gemma3.window // 2,
             "gemma3 half ring"),
            ((1, SLICE_SLOTS, KV, G, HD), SLICE_SLOTS, "qwen3 1 x 8,200 slice")]
        for dtype in (torch.float32, torch.bfloat16):
            for i, (shape, valid, tag) in enumerate(lse_cases):
                check_decode(100 + i, *shape, valid, tag, None, dtype)
    _phase("check-attn", check_attn, failures)

    # 12. serve: qwen3-0.6b at full width and depth --------------------------
    def expected_launches(cfg, steps):
        """(B3, B4, B5) launches of one prefill and ``steps`` decode steps:
        one attention kernel per layer (dense, MoE, VLM; the enc-dec
        model's encoder and decoder layers in the prefill, its decoder
        layers in decode) or shared site (hybrid) and one B5 per Mamba2
        block."""
        if cfg.family in ("dense", "moe", "vlm"):
            return cfg.n_layers, cfg.n_layers * steps, 0
        if cfg.family == "encdec":
            return cfg.enc_layers + cfg.dec_layers, cfg.dec_layers * steps, 0
        sites = cfg.n_layers // cfg.hybrid_attn_every \
            if cfg.family == "hybrid" else 0
        return sites, sites * steps, cfg.n_layers

    def serve_prompt(cfg):
        """(prompt length, vision embeddings) of a served batch: whisper's
        1500 frames; the VLM's 1024 vision embeddings + 1024 tokens."""
        if cfg.family == "encdec":
            return CROSS_FRAMES, None
        return SERVE_PROMPT, cfg.vision_tokens or None

    def serve_model(cfg, cuts="", keep=None):
        """``Server`` with ``cfg`` at full width (and depth, but for
        ``cuts``), seeded weights on the card: a first call, then a counted
        one, which must launch the kernels ``expected_launches`` says and
        give the same tokens. Returns the counted call's (B3, B4, B5)
        launches; ``keep`` (a dict) keeps the server and its tokens."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        prompt, n_vis = serve_prompt(cfg)
        t0 = time.perf_counter()
        srv = Server(cfg, SERVE_BATCH, prompt, SERVE_NEW, eos_id=-1,
                     device=dev)
        srv.init_params(SEED)
        torch.cuda.synchronize()
        n_par = sum(p.numel() for p in srv.model.parameters())
        nbytes = sum(p.numel() * p.element_size()
                     for p in srv.model.parameters())
        seeded = torch.cuda.max_memory_allocated(dev)
        print(f"[serve] {cfg.name}: {cfg.n_layers} layers{cuts}, d_model "
              f"{cfg.d_model}, {cfg.dtype}, kv cache {cfg.kv_dtype}, {n_par} "
              f"parameters ({nbytes / 1e9:.3f} GB), seeded in "
              f"{time.perf_counter() - t0:.2f} s (peak while seeding "
              f"{seeded / 1e9:.3f} GB)", flush=True)
        batch = request_batch(cfg, SERVE_BATCH, prompt,
                              np.random.default_rng(SEED), vision_tokens=n_vis)
        shapes = {k: v.shape for k, v in batch.items()}
        first = srv.generate(batch)
        torch.cuda.reset_peak_memory_stats(dev)
        b3.launches = b4.launches = b5.launches = 0
        out = srv.generate(batch)
        got = (b3.launches, b4.launches, b5.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        want = expected_launches(cfg, SERVE_NEW - 1)
        for tag, o in (("first call", first), ("counted call", out)):
            print(f"[serve] {cfg.name} {tag}: batch {shapes}: prefill "
                  f"{1e3 * o['prefill_s']:.2f} ms, "
                  f"decode {o['tokens_generated']} tokens in "
                  f"{1e3 * o['decode_s']:.2f} ms "
                  f"({o['decode_tok_per_s']:.1f} tok/s)", flush=True)
        print(f"[serve] {cfg.name} counted call: launches B3 {got[0]}, B4 "
              f"{got[1]}, B5 {got[2]} (expected {want}), peak device memory "
              f"{peak / 1e9:.3f} GB; first row {out['tokens'][0][:8]}",
              flush=True)
        assert got == want, (got, want)
        toks = out["tokens"]
        assert toks.shape == (SERVE_BATCH, SERVE_NEW), toks.shape
        assert ((toks >= 0) & (toks < cfg.vocab)).all()
        np.testing.assert_array_equal(toks, first["tokens"])   # greedy
        with torch.inference_mode():
            lg, _ = srv.model.prefill(request_batch(
                cfg, 1, 64, np.random.default_rng(SEED)))
        assert lg.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(
            lg).all())
        if keep is not None:
            keep.update(server=srv, tokens=toks)
        return got

    def serve():
        launches["serve_b3"], launches["serve_b4"], _ = serve_model(qwen)
    _phase("serve", serve, failures)

    # 13. serve-check: the kernels against the plain path in one model -----
    def serve_check(cfgs, dtype="float32", s=1000, n_vis=None):
        """Each of ``cfgs`` (cut in depth, full width) in ``dtype``: prefill
        of ``s`` tokens (``request_batch``'s: whisper's 1500 frames and 187
        tokens; ``n_vis`` vision embeddings and ``s - n_vis`` tokens for the
        VLM) and 4 greedy steps through the kernels, then the same tokens
        through the plain versions on the card. float32: logits to 1e-4,
        equal greedy tokens, and (but with the int8 cache, whose prefill
        attends unquantized keys) decode logits against the prefill of the
        longer prompt (2e-3). bfloat16: logits within 2e-2 + 2e-2 |plain|
        (the attention kernels' bf16 tolerance); whether the plain path would
        pick the same tokens is printed."""
        gc.collect()
        torch.cuda.empty_cache()
        b, steps = 2, 4
        for cfg in cfgs:
            cfg = dataclasses.replace(cfg, dtype=dtype)
            model = build_model(cfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(SEED))
            batch = request_batch(cfg, b, CROSS_FRAMES if cfg.family ==
                                  "encdec" else s,
                                  np.random.default_rng(SEED + 1), n_vis)
            prompt = torch.as_tensor(batch["tokens"], device=dev)
            # decode positions continue the decoder's sequence
            s0 = prompt.shape[1] + (n_vis or 0) * (cfg.family == "vlm")

            def greedy(force=None):
                """Logits of the prefill and each step, and the greedy tokens
                (fed back, or ``force``'s tokens when given)."""
                lg, c = model.prefill(batch, cache_len=s0 + steps)
                logits, toks = [lg], []
                for j in range(steps):
                    toks.append(logits[-1][:, -1].argmax(-1)[:, None])
                    feed = toks[-1] if force is None else force[:, j:j + 1]
                    lg, c = model.decode_step(c, {"token": feed,
                                                  "pos": s0 + j})
                    logits.append(lg)
                return torch.cat(logits, 1).float(), torch.cat(toks, 1)

            with torch.inference_mode():
                b3.launches = b4.launches = b5.launches = 0
                lk, tk = greedy()
                got = (b3.launches, b4.launches, b5.launches)
                assert got == expected_launches(cfg, steps), (cfg.name, got)
                with plain_kernels():
                    lp, tp = greedy(force=tk)
                err = float((lk - lp).abs().max())
                depth = f"{cfg.enc_layers} + {cfg.dec_layers}" \
                    if cfg.family == "encdec" else cfg.n_layers
                print(f"[serve-check] {depth}-layer {dtype} "
                      f"{cfg.name} (kv cache {cfg.kv_dtype}), batch "
                      f"{ {k: v.shape for k, v in batch.items()} }, {steps} "
                      f"greedy steps: kernels "
                      f"vs plain logits max_abs_err {err:.3g} (|logit| <= "
                      f"{float(lp.abs().max()):.3g}), tokens equal "
                      f"{bool(torch.equal(tk, tp))}", flush=True)
                if dtype == "bfloat16":
                    tol = ATTN_TOL[torch.bfloat16]
                    n_bad = int(((lk - lp).abs() > tol + tol * lp.abs())
                                .sum())
                    print(f"[serve-check] {cfg.name} bfloat16: logits beyond "
                          f"{tol:g} + {tol:g} |plain|: {n_bad}", flush=True)
                    assert bool(torch.isfinite(lk).all()) and n_bad == 0
                    del model
                    continue
                # float32 on both sides; sums in another order
                torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
                assert torch.equal(tk, tp)
                if cfg.kv_dtype == "int8":
                    del model
                    continue
                seq = torch.cat([prompt, tk], 1)
                tf = 0.0
                for j in range(1, steps + 1):
                    want, _ = model.prefill(
                        {**batch, "tokens": seq[:, :prompt.shape[1] + j]})
                    # the reference's own teacher-forced tolerance
                    torch.testing.assert_close(lk[:, j], want[:, -1],
                                               rtol=2e-3, atol=2e-3)
                    tf = max(tf, float((lk[:, j] - want[:, -1]).abs().max()))
                print(f"[serve-check] {cfg.name} teacher-forced: decode vs "
                      f"prefill logits max_abs_err {tf:.3g}", flush=True)
            del model

    def serve_checks():
        qwen2 = dataclasses.replace(qwen, n_layers=2)
        serve_check([qwen2])
        serve_check([qwen2], "bfloat16")
    _phase("serve-check", serve_checks, failures)

    # 13b. serve-mesh: the server tensor-parallel on a device mesh --------
    def serve_mesh():
        import torch.distributed as dist

        from repro_torch.runtime import elastic_mesh
        # (a) an nccl world of one: Server(mesh=elastic_mesh(model=1)) in
        # turns with the meshless Server, bit for bit
        mesh = elastic_mesh(model=1)
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        free_card()
        batch = request_batch(qwen, SERVE_BATCH, SERVE_PROMPT,
                              np.random.default_rng(SEED))
        servers = {}
        for name, m in (("none", None), ("mesh", mesh)):
            servers[name] = Server(qwen, SERVE_BATCH, SERVE_PROMPT,
                                   SERVE_NEW, eos_id=-1, mesh=m, device=dev)
            servers[name].init_params(SEED)
        runs = []
        for name in ("none", "mesh", "mesh", "none"):
            b3.launches = b4.launches = b5.launches = 0
            o = servers[name].generate(batch)
            runs.append((name, o["tokens"], (b3.launches, b4.launches,
                                              b5.launches),
                         round(1e3 * o["prefill_s"], 2),
                         round(o["decode_tok_per_s"], 1)))
        want = expected_launches(qwen, SERVE_NEW - 1)
        for name, toks, n, _, _ in runs:
            assert n == want, (name, n, want)
            np.testing.assert_array_equal(toks, runs[0][1])
        print(f"[serve-mesh] (a) qwen3-0.6b bfloat16 on "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (nccl) in turns "
              f"with the meshless Server (prefill ms, decode tok/s): "
              f"{[(nm, p, t) for nm, _, _, p, t in runs]}; tokens bit for "
              f"bit, launches B3 {want[0]} B4 {want[1]} each", flush=True)
        bf16_tokens = runs[0][1]
        del servers
        free_card()
        # (b) two gloo ranks on cuda:0, elastic_mesh(model=2): the
        # meshless float32 runs first, on this card, for the ranks to meet
        want_np = {"bf16.tokens": bf16_tokens}
        for tag, arch, layers in MESH_CHECKS:
            cfg = mesh_check_cfg(arch, layers)
            model = build_model(cfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(SEED))
            lg, tk = greedy_run(model, request_batch(
                cfg, 2, MESH_PROMPT, np.random.default_rng(SEED + 1)),
                MESH_STEPS)
            want_np[f"{tag}.logits"] = lg.cpu().numpy()
            want_np[f"{tag}.tokens"] = tk.cpu().numpy()
            del model
            free_card()
        with tempfile.TemporaryDirectory() as tmp:
            np.savez(f"{tmp}/want.npz", **want_np)
            procs = [subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-rank",
                 str(r), tmp], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(2)]
            try:
                logs = [p.communicate(timeout=600)[0] for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for r, (p, log) in enumerate(zip(procs, logs)):
                print(log.rstrip(), flush=True)
                assert p.returncode == 0, f"rank {r} failed"
            got = [dict(np.load(f"{tmp}/serve{r}.npz")) for r in range(2)]
        heads = {"qwen3": qwen.n_heads // 2, "mixtral": mixtral.n_heads // 2,
                 "mamba2": mamba2.ssm_heads // 2}
        for r, o in enumerate(got):
            assert tuple(o["bf16.launches"]) == want, (r, o["bf16.launches"])
            assert o["bf16.heads"].tolist() == [[H // 2, KV // 2]], \
                o["bf16.heads"]
            assert bool(o["bf16.repeat"])
            np.testing.assert_array_equal(o["bf16.tokens"],
                                          got[0]["bf16.tokens"])
            for tag, arch, layers in MESH_CHECKS:
                cfg = mesh_check_cfg(arch, layers)
                assert int(o[f"{tag}.heads"]) == heads[tag], tag
                assert tuple(o[f"{tag}.launches"]) == expected_launches(
                    cfg, MESH_STEPS), (tag, o[f"{tag}.launches"])
                # float32 partial sums add in another order
                np.testing.assert_allclose(o[f"{tag}.logits"],
                                           want_np[f"{tag}.logits"],
                                           rtol=1e-4, atol=1e-4, err_msg=tag)
                np.testing.assert_array_equal(o[f"{tag}.tokens"],
                                              want_np[f"{tag}.tokens"])
                np.testing.assert_allclose(o[f"{tag}.logits"],
                                           o[f"{tag}.plain"], rtol=1e-4,
                                           atol=1e-4, err_msg=tag)
                np.testing.assert_array_equal(o[f"{tag}.tokens"],
                                              o[f"{tag}.plain_tokens"])
            np.testing.assert_allclose(o["data2.logits"],
                                       want_np["qwen3.logits"], rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_array_equal(o["data2.tokens"],
                                          want_np["qwen3.tokens"])
        print(f"[serve-mesh] (b) two gloo ranks on cuda:0: qwen3-0.6b "
              f"bfloat16 launches B3 {want[0]} B4 {want[1]} a rank at "
              f"{H // 2} q / {KV // 2} kv heads, tokens equal the world of "
              f"one's {np.array_equal(got[0]['bf16.tokens'], bf16_tokens)}; "
              f"float32 qwen3, mamba2, mixtral and (data 2, model 1) within "
              f"1e-4 of the meshless runs, tokens equal, kernels vs plain "
              f"within 1e-4 on both ranks", flush=True)
    _phase("serve-mesh", serve_mesh, failures)

    # 14. time-attn: B3 and B4 at the serving shapes ------------------------
    def in_turns(tag, kernel, library, plain, reps, plain_reps, rounds=5,
                 ceiling=None):
        """Kernel and library call (and ``ceiling``, if given) timed in
        turns, ``rounds`` times each, then the plain version once; medians
        of the device times (the ceiling's last)."""
        k, lib, ceil = [], [], []
        for _ in range(rounds):
            k.append(queued_ms(kernel, reps))
            lib.append(queued_ms(library, reps))
            if ceiling is not None:
                ceil.append(queued_ms(ceiling, reps))
        p = queued_ms(plain, plain_reps)
        queued = all(r[2] for r in k + lib + ceil) and p[2]
        extra = f", read ceiling ms per round {[round(r[0], 5) for r in ceil]}" \
            if ceil else ""
        print(f"[time-attn] {tag}: kernel ms per round "
              f"{[round(r[0], 5) for r in k]} (host ms per call "
              f"{float(np.median([r[1] for r in k])):.4f}), sdpa ms per "
              f"round {[round(r[0], 5) for r in lib]}{extra}, plain "
              f"{p[0]:.4f} ms; every call queued ahead of the device: "
              f"{queued}", flush=True)
        out = (float(np.median([r[0] for r in k])),
               float(np.median([r[0] for r in lib])), p[0])
        return out + (float(np.median([r[0] for r in ceil])),) if ceil \
            else out

    def time_flash(tag, kv, g, hd, S=SERVE_PROMPT, causal=True, window=0):
        """B3 at a serving prefill (bf16, batch SERVE_BATCH, ``S`` tokens,
        ``kv`` kv heads of ``g`` query heads each; causal, banded or
        bidirectional) against SDPA in turns (a boolean band mask for a
        window); returns the timing record. The bound is ``fa.cost``'s: the
        band's pairs."""
        dt = torch.bfloat16
        B, h = SERVE_BATCH, kv * g
        q = randn((B, S, kv, g, hd), dt, 1)
        k, v = randn((B, S, kv, hd), dt, 2), randn((B, S, kv, hd), dt, 3)
        qs = q.reshape(B, S, h, hd).transpose(1, 2).contiguous()
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        band = None
        if window:
            qp = torch.arange(S, device=dev)[:, None]
            kp = torch.arange(S, device=dev)[None, :]
            band = (kp > qp - window) & ((kp <= qp) if causal else True)

        def sdpa():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=band,
                is_causal=causal and band is None, enable_gqa=True)

        def kernel():
            return ops.flash_attention(q, k, v, causal=causal, window=window)
        ms, lib, plain = in_turns(
            f"B3 {tag}", kernel, sdpa,
            lambda: flash_plain(q, k, v, causal, window), 20, 3)
        lib_err = float((sdpa().transpose(1, 2).reshape(q.shape).float()
                         - kernel().float()).abs().max())
        folded = (q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3),
                  v.permute(0, 2, 1, 3))
        work = fa.cost(*folded, causal=causal, window=window)
        flops, nbytes = work["flops"], work["bytes"]
        # what the wgmma route issues: whole tiles, P.V for hi and lo
        issued = fa.issued_flops(*folded, causal=causal, window=window)
        t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        rec_ = dict(ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"[time-attn] B3 {tag} bf16 q {tuple(q.shape)} causal "
              f"{causal} window {window}, route {fa.route(hd, dt)}: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s of the band, "
              f"{issued / ms / 1e9:.2f} TFLOP/s issued: {issued:.4g} "
              f"tensor-core FLOPs), plain "
              f"{plain:.3f} ms, sdpa {lib:.4f} ms ({flops / lib / 1e9:.2f} "
              f"TFLOP/s; max |diff| {lib_err:.3g}), bound "
              f"{rec_['bound_ms']:.4f} ms ({rec_['bound_by']}: {flops:.4g} "
              f"FLOPs, {nbytes:.4g} bytes)", flush=True)
        return rec_

    def time_decode(tag, kv, g, hd, C=serve_cache, valid=SERVE_PROMPT,
                    B=SERVE_BATCH):
        """B4 at a serving decode step (a bf16 cache of ``B`` rows of ``C``
        slots, ``valid`` live) against SDPA with a slot mask in turns, with
        the read ceiling in the same turns: ``torch.sum`` in float32 over
        the same live K and V. Then a cold figure, the calls rotating over
        copies of the cache that exceed 4 x the 50 MB L2, and B4's time by
        grid size (``blocks=``) beside the default grid."""
        dt = torch.bfloat16
        h = kv * g
        qd = randn((B, kv, g, hd), dt, 4)
        kc, vc = randn((B, C, kv, hd), dt, 5), randn((B, C, kv, hd), dt, 6)
        qsd = qd.reshape(B, h, 1, hd)
        ksd, vsd = kc.transpose(1, 2).contiguous(), \
            vc.transpose(1, 2).contiguous()
        live = (torch.arange(C, device=dev) < valid)[None, None, None, :]

        def sdpa_d():
            return F.scaled_dot_product_attention(qsd, ksd, vsd,
                                                  attn_mask=live,
                                                  enable_gqa=True)

        def read():
            return (kc[:, :valid].sum(dtype=torch.float32),
                    vc[:, :valid].sum(dtype=torch.float32))
        ms, lib, plain, read_ms = in_turns(
            f"B4 {tag}", lambda: ops.decode_attention(qd, kc, vc, valid),
            sdpa_d, lambda: decode_plain(qd, kc, vc, valid), 50, 20,
            ceiling=read)
        # cold: every call on another copy of the cache, > 4 x the L2
        n_copies = -(-4 * L2_BYTES // (kc.nbytes + vc.nbytes)) + 1
        copies = [(kc.clone(), vc.clone()) for _ in range(n_copies)]
        turn = iter(range(10 ** 9))

        def cold_call():
            kx, vx = copies[next(turn) % n_copies]
            return ops.decode_attention(qd, kx, vx, valid)
        cold = float(np.median([queued_ms(cold_call, 50)[0]
                                for _ in range(3)]))
        del copies
        # the grid: the default (da.default_grid over the SMs times the
        # blocks that fit one) against multiples of the SMs
        kf, vf = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slots = sms * da._blocks_per_sm(hd, dt, g)
        rows = B * kv * -(-g // da.group_size(g))
        chosen = da.default_grid(rows, -(-valid // da.geometry(hd, dt)[0]),
                                 slots)
        sweep = {n: min(queued_ms(lambda: da.decode_attention_folded(
            qd, kf, vf, valid, blocks=n), 50)[0] for _ in range(3))
            for n in sorted({sms // 2, sms, 3 * sms // 2, 2 * sms, 3 * sms,
                             4 * sms, slots, chosen})}
        print(f"[time-attn] B4 {tag} ms by grid (best of 3 rounds; chosen "
              f"{chosen} of {slots} slots = {sms} SMs x {slots // sms}): "
              f"{', '.join(f'{n}: {t:.5f}' for n, t in sweep.items())}",
              flush=True)
        lib_err = float((sdpa_d().reshape(qd.shape).float()
                         - ops.decode_attention(qd, kc, vc, valid).float()
                         ).abs().max())
        work = da.cost(qd, kf, vf, valid)
        flops, nbytes = work["flops"], work["bytes"]
        t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        rec_ = dict(ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"[time-attn] B4 {tag} bf16 q {tuple(qd.shape)} cache "
              f"{tuple(kc.shape)} valid {valid}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e9:.3f} TB/s; cold {cold:.4f} ms over "
              f"{n_copies} copies, {nbytes / cold / 1e9:.3f} TB/s), plain "
              f"{plain:.3f} ms, sdpa {lib:.4f} ms ({nbytes / lib / 1e9:.3f} "
              f"TB/s; max |diff| {lib_err:.3g}), read ceiling "
              f"{read_ms:.4f} ms ({nbytes / read_ms / 1e9:.3f} TB/s), bound "
              f"{rec_['bound_ms']:.4f} ms ({rec_['bound_by']}: {nbytes:.4g} "
              f"bytes)", flush=True)
        return rec_

    def time_attn():
        zkv, zhd = zamba2.n_kv_heads, zamba2.head_dim
        zg = zamba2.n_heads // zkv
        timing["flash"] = time_flash("qwen3", KV, G, HD)
        time_flash("zamba2", zkv, zg, zhd)
        timing["decode"] = time_decode("qwen3", KV, G, HD)
        time_decode("zamba2", zkv, zg, zhd)
        gkv, ghd, w = gemma3.n_kv_heads, gemma3.head_dim, gemma3.window
        gg = gemma3.n_heads // gkv
        timing["flash gemma3 local"] = time_flash("gemma3 local", gkv, gg,
                                                  ghd, window=w)
        timing["flash whisper encoder"] = time_flash(
            "whisper encoder", whisper.n_kv_heads, 1, whisper.head_dim,
            S=CROSS_FRAMES, causal=False)
        timing["decode gemma3 ring"] = time_decode("gemma3 ring", gkv, gg,
                                                   ghd, C=w, valid=w)
        timing["decode slice"] = time_decode(
            "qwen3 1 x 8,200 slice", KV, G, HD, C=SLICE_SLOTS,
            valid=SLICE_SLOTS, B=1)
        for cfg in (gemma7, starcoder2):
            kv, hd = cfg.n_kv_heads, cfg.head_dim
            timing[f"flash {cfg.name}"] = time_flash(
                cfg.name, kv, cfg.n_heads // kv, hd)
            timing[f"decode {cfg.name}"] = time_decode(
                cfg.name, kv, cfg.n_heads // kv, hd)
        time_lse("qwen3 serve", SERVE_BATCH, serve_cache, SERVE_PROMPT)
        half = (SEQ_PROMPT + SEQ_NEW) // 2
        time_lse("qwen3 seq-decode slice", 1, half, SEQ_PROMPT + 1 - half)

    def time_lse(tag, B, C, valid):
        """B4 with and without its log-sum-exp output, in turns (five
        rounds each, medians), at qwen3-0.6b's heads in bfloat16."""
        qd = randn((B, KV, G, HD), torch.bfloat16, 7)
        kc = randn((B, C, KV, HD), torch.bfloat16, 8)
        vc = randn((B, C, KV, HD), torch.bfloat16, 9)
        plain_, lse_ = [], []
        for _ in range(5):
            plain_.append(queued_ms(
                lambda: ops.decode_attention(qd, kc, vc, valid), 50)[0])
            lse_.append(queued_ms(lambda: ops.decode_attention(
                qd, kc, vc, valid, return_lse=True), 50)[0])
        ms, ms_lse = float(np.median(plain_)), float(np.median(lse_))
        timing[f"decode lse {tag}"] = dict(ms=ms, lse_ms=ms_lse)
        print(f"[time-attn] B4 {tag} bf16 q {tuple(qd.shape)} cache "
              f"{tuple(kc.shape)} valid {valid}: without lse {ms:.5f} ms, "
              f"with lse {ms_lse:.5f} ms (rounds {[round(t, 5) for t in plain_]}"
              f" / {[round(t, 5) for t in lse_]})", flush=True)
    _phase("time-attn", time_attn, failures)

    # 15. check-ssd: B5 against its plain version ---------------------------
    rec["ssd_max_abs_err"] = 0.0

    def ssd_shape(cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT):
        """(BC, Q, H, P, N) of one Mamba2 prefill of ``cfg``."""
        return (batch * prompt // cfg.ssm_chunk, cfg.ssm_chunk,
                cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)

    def ssd_inputs(shape, seed):
        """xc, cum, B, C drawn as the reference test draws them: x, B, C
        standard normal, log-decay -|N(0, 1)| * 0.1 summed within chunks."""
        bc, q, h, p, n = shape
        gen.manual_seed(seed)
        x = torch.randn((bc, q, h, p), generator=gen, device=dev)
        la = -torch.randn((bc, q, h), generator=gen, device=dev).abs() * 0.1
        B = torch.randn((bc, q, n), generator=gen, device=dev)
        C = torch.randn((bc, q, n), generator=gen, device=dev)
        return x, la.cumsum(1), B, C

    def ssd_check(tag, x, cum, B, C):
        """B5 against its plain version: every element within tol + tol *
        |plain|, all finite. Returns the kernel's output."""
        got = b5(x, cum, B, C)
        torch.cuda.synchronize()
        want = ssd_scan.ssd_intra_plain(x, cum, B, C)
        err = (got - want).abs()
        n_bad = int((err > SSD_TOL + SSD_TOL * want.abs()).sum())
        mx = float(err.max())
        rec["ssd_max_abs_err"] = max(rec["ssd_max_abs_err"], mx)
        route = ssd_scan.route(x.shape[-1], B.shape[-1])
        print(f"[check-ssd] {tag} {tuple(x.shape)} N {B.shape[-1]} ({route}): "
              f"max_abs_err {mx:.3g} (|plain| <= {float(want.abs().max()):.3g}"
              f", tol {SSD_TOL:g}) outside {n_bad}", flush=True)
        assert bool(torch.isfinite(got).all()), tag
        assert n_bad == 0, f"B5 {tag}: {n_bad} elements beyond tol"
        return got

    def captured_prefill_inputs():
        """The inputs B5 gets from a real prefill: one full-width float32
        mamba2-2.7b block (seeded weights) over 2 prompts of 1024 tokens
        (no padding, so B and C reach B5 as column slices of the block's
        fused activation)."""
        cfg = dataclasses.replace(mamba2, n_layers=1, dtype="float32")
        model = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        seen = []
        real = ops.ssd_intra

        def capture(*args):
            seen.append(args)
            return real(*args)
        ops.ssd_intra = capture
        try:
            with torch.inference_mode():
                model.prefill({"tokens": np.random.default_rng(SEED).integers(
                    2, cfg.vocab, (2, 1024))})
        finally:
            ops.ssd_intra = real
        assert len(seen) == 1, len(seen)
        return [t.flatten(0, 1) for t in seen[0]]

    def check_ssd():
        for i, shape in enumerate([(1, 16, 1, 8, 4), (2, 64, 2, 32, 16),
                                   (6, 37, 1, 16, 8), (1, 128, 4, 64, 128),
                                   (5, 17, 3, 64, 128), (3, 37, 80, 64, 128),
                                   (2, 200, 3, 128, 64)]):
            ssd_check("sweep", *ssd_inputs(shape, 200 + i))
        ssd_check("mamba2 serve", *ssd_inputs(ssd_shape(mamba2), 210))
        ssd_check("zamba2 serve", *ssd_inputs(ssd_shape(zamba2), 211))
        x, cum, B, C = ssd_inputs((4, 256, 6, 64, 128), 212)
        wide = torch.cat([B[..., :8], B, C], -1)         # slices of a row
        ssd_check("B, C column slices", x, cum, wide[..., 8:136],
                  wide[..., 136:])
        x, cum, B, C = captured_prefill_inputs()
        assert B.stride(-2) != B.shape[-1], "expected a column slice"
        ssd_check("mamba2 prefill inputs", x, cum, B, C)
        for i, shape in enumerate([(2, 100, 3, 16, 8), (2, 100, 3, 64, 128),
                                   (2, 256, 5, 64, 64)]):
            x, _, B, C = ssd_inputs(shape, 213 + 10 * i)
            q, h = shape[1:3]
            cum = torch.linspace(0.0, -500.0, q, device=dev)[None, :, None] \
                .expand(shape[0], q, h).contiguous()     # exp(+500) above
            ssd_check("steep decay", x, cum, B, C)
        # the wgmma route's edges: ragged chunks, a head count its groups
        # do not divide, one head, B and C sliced at another offset
        for i, shape in enumerate([(6, 232, 80, 64, 128), (5, 17, 112, 64, 64),
                                   (7, 37, 80, 64, 128), (3, 256, 17, 64, 64),
                                   (8, 256, 1, 64, 128), (4, 199, 1, 64, 64)]):
            ssd_check("wgmma edge", *ssd_inputs(shape, 230 + i))
        x, cum, B, C = ssd_inputs((4, 232, 12, 64, 64), 240)
        wide = torch.cat([C[..., :20], B, C, B[..., :4]], -1)
        ssd_check("B, C column slices at 20", x, cum, wide[..., 20:84],
                  wide[..., 84:148])
        for schedule in (dict(heads=5), dict(window=1, blocks=9),
                         dict(draw=False)):
            x, cum, B, C = ssd_inputs((6, 232, 10, 64, 128), 241)
            got = ssd_scan._launch(x, cum, B, C, schedule)
            same = bool(torch.equal(got, b5(x, cum, B, C)))
            print(f"[check-ssd] schedule {schedule}: bit for bit the "
                  f"default's: {same}", flush=True)
            assert same, schedule
        x, cum, B, C = ssd_inputs((2, 256, 8, 64, 128), 214)
        before = ssd_check("causality", x, cum, B, C)
        x2, B2 = x.clone(), B.clone()
        x2[:, 150:] += 5.0
        B2[:, 150:] -= 3.0
        after = b5(x2, cum, B2, C)
        torch.cuda.synchronize()
        same = bool(torch.equal(before[:, :150], after[:, :150]))
        print(f"[check-ssd] causality: rows before 150 equal after changing "
              f"x and B from row 150: {same}", flush=True)
        assert same and not torch.equal(before[:, 150:], after[:, 150:])
    _phase("check-ssd", check_ssd, failures)

    # 13-14. serve-ssm, serve-hybrid: full width and depth -------------------
    def serve_ssm():
        launches["serve_b5"] = serve_model(mamba2)[2]
    _phase("serve-ssm", serve_ssm, failures)
    _phase("serve-hybrid", serve_model, failures, zamba2)

    # 18. serve-check-ssm: kernels against plain inside both models ----------
    _phase("serve-check-ssm", serve_check, failures,
           [dataclasses.replace(mamba2, n_layers=2),
            dataclasses.replace(zamba2, n_layers=7)])

    # 19. time-ssd: B5 at the serving shapes --------------------------------
    def ssd_bound(args):
        """Least time of one B5 launch on ``args``, two ways, from
        ``ssd_scan.cost``. The float32 CUDA-core bound: the causal band's
        operations (scores C_i . B_j once per chunk, 2N each; per head a
        weight, 3 operations, and P multiply-adds) over the fp32 peak,
        against x and out once, cum, B and C once over HBM bandwidth. The
        bound of the kernel's route: three TF32 products (3xTF32) for each
        of the band's multiply-adds at the dense TF32 tensor-core peak,
        against the same bytes."""
        work = ssd_scan.cost(*args)
        ops_, mma, nbytes = work["flops"], work["tf32_flops"], work["bytes"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        out = {}
        for name, t_ops in (("fp32", ops_ / F32_OPS_PER_S),
                            ("route", mma / TF32_OPS_PER_S)):
            out[name] = (1e3 * max(t_ops, t_bytes),
                         "operations" if t_ops >= t_bytes else "bytes")
        return out, ops_, mma, nbytes

    def time_ssd():
        for cfg in (mamba2, zamba2):
            shape = ssd_shape(cfg)
            args = ssd_inputs(shape, 220)
            route = ssd_scan.route(*shape[3:])
            # the shape's route in turns with the mma.sync route (the
            # earlier kernel, which every shape can take) and with the
            # wgmma route's blocks walking the work list statically
            # instead of drawing from a counter
            k, old, walk = [], [], []
            for _ in range(5):
                k.append(queued_ms(lambda: b5(*args), 20))
                old.append(queued_ms(lambda: ssd_scan._launch(
                    *args, dict(route="mma")), 20))
                walk.append(queued_ms(lambda: ssd_scan._launch(
                    *args, dict(draw=False)), 20))
            p = queued_ms(lambda: ssd_scan.ssd_intra_plain(*args), 3)
            ms = float(np.median([r[0] for r in k]))
            old_ms = float(np.median([r[0] for r in old]))
            walk_ms = float(np.median([r[0] for r in walk]))
            bounds, ops_, mma, nbytes = ssd_bound(args)
            (f_ms, f_by), (r_ms, r_by) = bounds["fp32"], bounds["route"]
            issued = ssd_scan.cost(*args)["issued_flops"]
            print(f"[time-ssd] B5 {cfg.name} {shape} route {route}: kernel "
                  f"ms per round {[round(r[0], 5) for r in k]} (host ms per "
                  f"call {float(np.median([r[1] for r in k])):.4f}), median "
                  f"{ms:.4f} ms ({issued / ms / 1e9:.2f} TFLOP/s of issued "
                  f"3xTF32 work, {issued:.4g} operations over whole tiles; "
                  f"{ops_ / ms / 1e9:.2f} TFLOP/s of the band's fp32 "
                  f"operations, {mma / ms / 1e9:.2f} of its 3xTF32 products); "
                  f"the mma.sync route in turns {old_ms:.4f} ms (rounds "
                  f"{[round(r[0], 5) for r in old]}); the static walk in "
                  f"turns {walk_ms:.4f} ms (rounds "
                  f"{[round(r[0], 5) for r in walk]}); plain {p[0]:.3f} ms, "
                  f"library none; bound of the 3xTF32 route {r_ms:.4f} ms "
                  f"({r_by}: {mma:.4g} TF32 operations, {nbytes:.4g} bytes), "
                  f"fp32 CUDA-core bound {f_ms:.4f} ms ({f_by}: {ops_:.4g} "
                  f"operations); every call queued ahead of the device: "
                  f"{all(r[2] for r in k + old + walk) and p[2]}",
                  flush=True)
            # the wgmma route's schedule: heads a work item by chunks a
            # window of the work list (the persistent grid is one block an
            # SM: its shared memory admits no second)
            sweep = {}
            for heads in (8, 16):
                for window in (1, 2, 4, 8, 64):
                    sweep[heads, window] = float(np.median([queued_ms(
                        lambda: ssd_scan._launch(*args, dict(
                            heads=heads, window=window)), 10)[0]
                        for _ in range(3)]))
            best = min(sweep, key=sweep.get)
            chosen = (ssd_scan.head_group(shape[2]), ssd_scan.WINDOW)
            print(f"[time-ssd] B5 {cfg.name} sweep (heads, window): "
                  + ", ".join(f"{hw} {t:.4f}" for hw, t in sweep.items())
                  + f" ms; best {best} {sweep[best]:.4f} ms, the default "
                  f"{chosen} {sweep[chosen]:.4f} ms", flush=True)
            timing[f"ssd {cfg.name}"] = dict(ms=ms, plain_ms=p[0],
                                             library_ms=None, bound_ms=r_ms,
                                             bound_by=r_by)
        timing["ssd"] = timing[f"ssd {mamba2.name}"]
    _phase("time-ssd", time_ssd, failures)

    # 20. serve-families: every other family at full width ------------------
    #: each run: (config, its depth cut); the card's 80 GB force the cuts
    #: mixtral runs last, its server kept on the card for moe-a2a
    family_runs = [
        (gemma3, ""), (gemma7, ""), (starcoder2, ""),
        (dataclasses.replace(arctic, n_layers=2),
         " (of 35: a layer of 128 experts holds 13.6 B parameters)"),
        (internvl2, ""), (whisper, " (24 encoder + 24 decoder)"),
        (dataclasses.replace(qwen, kv_dtype="int8"), ""),
        (dataclasses.replace(mixtral, n_layers=16),
         " (of 32: 32 need 93.4 GB of bf16 weights)")]
    kept = {}

    def serve_families():
        for cfg, cuts in family_runs:
            got = serve_model(cfg, cuts, keep=kept if cfg.name ==
                              mixtral.name else None)
            launches[f"serve {cfg.name} {cfg.kv_dtype}"] = got
    _phase("serve-families", serve_families, failures)

    # 20b. moe-a2a: mixtral's experts dispatched with all_to_all ----------
    def greedy(prefill, decode, batch, prompt, steps):
        """``prefill(batch)`` and ``steps`` greedy ``decode(caches,
        {"token", "pos"})`` steps: every step's logits, the tokens, and the
        prefill and decode walls."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg, caches = prefill(batch)
            logits = [lg]
            tok = lg[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            toks = [tok.cpu().numpy()]
            t_prefill = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(steps):
                lg, caches = decode(caches, {"token": tok, "pos": prompt + i})
                logits.append(lg)
                tok = lg[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
                toks.append(tok.cpu().numpy())
        return logits, np.concatenate(toks, 1), t_prefill, \
            time.perf_counter() - t0

    def moe_a2a():
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.steps import (make_decode_objects,
                                              make_prefill_objects)
        from repro_torch.models.moe import capacity
        mesh = make_test_mesh()                  # the nccl world of one
        print(f"[moe-a2a] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
              f" ({mesh.device_type})", flush=True)
        # the 16-layer bf16 cell on serve-families' weights (no second
        # copy: the a2a models are built on meta and take its tensors)
        srv, want = kept.pop("server"), kept.pop("tokens")
        cfg, state = srv.cfg, srv.model.state_dict()
        cache = SERVE_PROMPT + SERVE_NEW
        shape = ShapeSpec(f"prefill {SERVE_PROMPT} + {SERVE_NEW} cache",
                          cache, SERVE_BATCH, "prefill")
        model, prefill_step, _ = make_prefill_objects(
            cfg, shape, device="meta", mesh=mesh, moe_impl="a2a")
        model.load_state_dict(state, assign=True)
        dmodel, serve_step, _ = make_decode_objects(
            cfg, shape, device="meta", mesh=mesh, moe_impl="a2a")
        dmodel.load_state_dict(state, assign=True)
        assert model.device.type == "cuda" and model.moe_impl == "a2a"
        batch = request_batch(cfg, SERVE_BATCH, SERVE_PROMPT,
                              np.random.default_rng(SEED))
        torch.cuda.reset_peak_memory_stats(dev)
        b3.launches = b4.launches = b5.launches = 0
        _, toks, t_pre, t_dec = greedy(prefill_step, serve_step, batch,
                                       SERVE_PROMPT, SERVE_NEW - 1)
        got = (b3.launches, b4.launches, b5.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        n_tok = SERVE_BATCH * SERVE_NEW
        print(f"[moe-a2a] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, "
              f"batch {SERVE_BATCH} x {SERVE_PROMPT} (capacity "
              f"{capacity(cfg, SERVE_BATCH * SERVE_PROMPT)} an expert lane),"
              f" moe_impl a2a: prefill "
              f"{1e3 * t_pre:.2f} ms, decode {n_tok} tokens in "
              f"{1e3 * t_dec:.2f} ms ({n_tok / t_dec:.1f} tok/s), launches "
              f"B3 {got[0]} B4 {got[1]} B5 {got[2]}, peak device memory "
              f"{peak / 1e9:.3f} GB; tokens equal scatter's "
              f"{np.array_equal(toks, want)}", flush=True)
        assert got == (16, 496, 0), got
        np.testing.assert_array_equal(toks, want)
        # scatter and a2a in turns on the same weights (scatter, a2a, a2a,
        # scatter), every call's tokens scatter's
        walls = {"scatter": [], "a2a": []}
        for impl in ("scatter", "a2a", "a2a", "scatter"):
            if impl == "scatter":
                o = srv.generate(batch)
                toks, t_pre, t_dec = o["tokens"], o["prefill_s"], \
                    o["decode_s"]
            else:
                _, toks, t_pre, t_dec = greedy(prefill_step, serve_step,
                                               batch, SERVE_PROMPT,
                                               SERVE_NEW - 1)
            np.testing.assert_array_equal(toks, want)
            walls[impl].append((round(1e3 * t_pre, 2),
                                round(n_tok / t_dec, 1)))
        print(f"[moe-a2a] in turns (prefill ms, decode tok/s): scatter "
              f"{walls['scatter']}, a2a {walls['a2a']}", flush=True)
        # where a decode's time goes: 31 steps from one prefill's caches,
        # profiled (device busy, idle share, top kernels) for each impl
        from repro_torch.launch.breakdown import profile
        for impl, (pre, dec) in (
                ("scatter", (lambda b: srv.model.prefill(b, cache_len=cache),
                             srv.model.decode_step)),
                ("a2a", (prefill_step, serve_step))):
            with torch.inference_mode():
                lg, caches = pre(batch)
            tok0 = lg[:, -1].argmax(dim=-1).to(torch.int32)[:, None]

            @torch.inference_mode()
            def decode_steps(dec=dec, caches=caches, tok0=tok0):
                tok = tok0
                for i in range(SERVE_NEW - 1):
                    lg, _ = dec(caches, {"token": tok,
                                         "pos": SERVE_PROMPT + i})
                    tok = lg[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
                    tok.cpu()
            prof = profile(f"mixtral-16-decode-{impl}", decode_steps, None)
            nccl = sum(t["ms"] for t in prof["top"] if "nccl" in
                       t["kernel"].lower())
            print(f"[moe-a2a] profiled decode, {impl}: wall "
                  f"{prof['wall_ms']:.1f} ms, device busy "
                  f"{prof['device_busy_ms']:.1f} ms, idle share "
                  f"{prof['idle_share']:.3f}, {prof['device_kernels']} "
                  f"kernel names, NCCL among the top 8 {nccl:.2f} ms; top "
                  f"{[(t['kernel'][:40], t['count'], round(t['ms'], 2)) for t in prof['top'][:5]]}",
                  flush=True)
            del caches
        del model, dmodel, state, srv
        gc.collect()
        torch.cuda.empty_cache()
        # 2-layer float32 at full width: a2a against scatter, bit for bit
        cfg2 = dataclasses.replace(mixtral, n_layers=2, dtype="float32")
        scatter = build_model(cfg2, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        a2a, _, _ = make_prefill_objects(
            cfg2, ShapeSpec("check", 1004, 2, "prefill"), device="meta",
            mesh=mesh, moe_impl="a2a")
        a2a.load_state_dict(scatter.state_dict(), assign=True)
        batch = request_batch(cfg2, 2, 1000, np.random.default_rng(SEED))
        ls, ts, _, _ = greedy(
            lambda b: scatter.prefill(b, cache_len=1004),
            scatter.decode_step, batch, 1000, 4)
        la, ta, _, _ = greedy(lambda b: a2a.prefill(b, cache_len=1004),
                              a2a.decode_step, batch, 1000, 4)
        equal = all(torch.equal(x, y) for x, y in zip(ls, la))
        print(f"[moe-a2a] 2-layer float32 {cfg2.name}, batch 2 x 1000, 4 "
              f"greedy steps: a2a vs scatter logits equal {equal}, tokens "
              f"equal {np.array_equal(ts, ta)}", flush=True)
        assert equal and np.array_equal(ts, ta)
    _phase("moe-a2a", moe_a2a, failures)

    # 21. serve-check-families: kernels against plain inside each family ----
    def serve_check_families():
        serve_check([dataclasses.replace(gemma3, n_layers=7)], s=1300)
        serve_check([dataclasses.replace(mixtral, n_layers=2)])
        serve_check([dataclasses.replace(internvl2, n_layers=2)], s=1300,
                    n_vis=internvl2.vision_tokens)
        serve_check([dataclasses.replace(whisper, enc_layers=2,
                                         dec_layers=2)])
        serve_check([dataclasses.replace(qwen, n_layers=2, kv_dtype="int8")])
        serve_check([dataclasses.replace(arctic, n_layers=1)], "bfloat16")
        serve_check([dataclasses.replace(gemma7, n_layers=2),
                     dataclasses.replace(starcoder2, n_layers=2)])
        serve_check([dataclasses.replace(gemma7, n_layers=2)], "bfloat16")
    _phase("serve-check-families", serve_check_families, failures)

    # 22. train-check: the training route's gradients, card against CPU ---
    _phase("train-check", train_check, failures, dev)

    # 23. train: qwen3-0.6b at full width and depth through Trainer --------
    _phase("train", train_run, failures, dev)

    # 24. train-mesh: the Trainer on a device mesh ----------------------------
    _phase("train-mesh", train_mesh, failures, dev)

    # 25. seq-decode: batch-1 sequence-parallel decode over two ranks ---------
    _phase("seq-decode", seq_decode, failures, dev)

    # 26. dryrun: the dry run's counts, and held against real steps ----------
    _phase("dryrun", dryrun, failures, dev)

    jax_loaded = "jax" in sys.modules
    print(f"[imports] jax loaded: {jax_loaded}")
    if jax_loaded:
        failures.append("imports")
    if failures:
        print(f"chip_smoke: FAILED phases: {', '.join(failures)}",
              file=sys.stderr)
        return 1
    t_main = timing["traffic qwen3-0.6b traffic bucket"]
    print(json.dumps({"kernels": [{
        "name": "schedule_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/schedule_sim.cu",
        "replaces": "src/repro/kernels/schedule_sim.py:58",
        "launches": launches["plan"],
        "max_abs_err": rec["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "traffic_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/traffic_sim.cu",
        "replaces": "src/repro/kernels/traffic_sim.py:66",
        "launches": launches["traffic"],
        "max_abs_err": rec["traffic_max_abs_err"],
        "ms": t_main["ms"], "plain_ms": t_main["plain_ms"],
        "bound_ms": t_main["bound_ms"], "bound_by": t_main["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:40",
        "launches": launches["serve_b3"],
        "max_abs_err": rec["flash_max_abs_err"], **timing["flash"]}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:34",
        "launches": launches["serve_b4"],
        "max_abs_err": rec["decode_max_abs_err"], **timing["decode"]}, {
        "name": "ssd_intra", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:34",
        "launches": launches["serve_b5"],
        "max_abs_err": rec["ssd_max_abs_err"], **timing["ssd"]}]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--serve-rank"]:
        sys.exit(serve_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--train-rank"]:
        sys.exit(train_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--seq-rank"]:
        sys.exit(seq_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
