#!/usr/bin/env python3
"""Drive the PyTorch port's planner and LM servers on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero with no
result line):

  1. build   — compile every CUDA kernel of ``_build.SOURCES`` (every
               ``src/repro_torch/kernels/csrc/*.cu``) with nvcc, one process
               per source, all started together;
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
 11. check-attn — B3 (flash prefill) and B4 (flash decode) against their
               plain versions on CUDA tensors, float32 to 2e-5 and bfloat16
               to 2e-2: qwen3-0.6b's serving shapes (batch 8, prompt 2048,
               cache 2080; causal and a 512 window; valid_len 1, 7, 1000,
               2048, 2080), zamba2-7b's (32 q and 32 kv heads of head_dim
               112; valid_len 1, 2049, 2079), windows whose first kv tile is
               wholly masked for some rows, a decode split with empty blocks,
               and ragged shapes of the CPU sweep (head_dim 16 to 256, 112
               among them);
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
 14. time-attn — B3 and B4 per launch at qwen3-0.6b's and zamba2-7b's
               serving shapes (CUDA events over calls queued behind a device
               sleep, five rounds in turns with one
               ``scaled_dot_product_attention`` call as the yardstick,
               medians), beside their plain versions and bounds;
 15. check-ssd — B5 (the SSD intra-chunk form) against its plain version
               on CUDA tensors, every element within 1e-4 + 1e-4 |plain|:
               the reference's sweep shapes, chunks of 17 and 37 rows,
               mamba2-2.7b's serving shape (64 chunks of 256, 80 heads of 64,
               state 128) and zamba2-7b's (112 heads, state 64), B and C as
               column slices, the inputs of a real full-width ``mamba_seq``
               prefill, a log-decay steep enough that exp overflows above the
               diagonal, and causality (future inputs leave past rows equal);
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
               no library yardstick), beside its plain version, the bound of
               its 3xTF32 tensor-core route and the float32 CUDA-core bound.

Kernel launch counters are zeroed just before each solve path and each
counted serve call and read just after; every solve's plans are replayed
by the numpy oracle ``simulate_np``. The last lines are the kernels' JSON
summary, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
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

RTOL = 1e-5          # kernel vs plain version: both float32
#: plan cost vs the float64 numpy oracle: a float32 running sum over up to
#: 11,100 edges (Fig. 8) drifts ~1e-5 relative from the float64 sum
ORACLE_RTOL = 1e-4
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s,
#: bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: device spin ahead of a timed stretch of attention calls (~25 ms at the
#: H100's clocks), so the host queues every call before the stretch starts
SLEEP_CYCLES = 50_000_000
#: attention kernels vs plain versions: the reference kernel tests'
#: tolerances (float32 sums in another order; bfloat16 outputs rounded)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: B5 vs its plain version: the reference kernel test's float32 tolerance
SSD_TOL = 1e-4
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


def decode_plain(q, k, v, valid_len):
    """B4's plain version on the model layout: q (B,K,G,hd), k/v the
    (B,C,K,hd) cache."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    return decode_attention_plain(q, k.permute(0, 2, 1, 3),
                                  v.permute(0, 2, 1, 3), valid_len)


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

    # 11. check-attn: B3 and B4 against their plain versions ----------------
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.breakdown import (SERVE_BATCH, SERVE_NEW,
                                              SERVE_PROMPT)
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.serve import Server
    from repro_torch.models import build_model
    b3, b4 = fa.flash_attention_folded, da.decode_attention_folded
    b5 = ssd_scan.ssd_intra_folded
    qwen, mamba2, zamba2 = (get(a) for a in ("qwen3-0.6b", "mamba2-2.7b",
                                              "zamba2-7b"))
    H, KV, HD = qwen.n_heads, qwen.n_kv_heads, qwen.head_dim
    G = H // KV
    serve_cache = SERVE_PROMPT + SERVE_NEW
    gen = torch.Generator(device=dev)
    rec.update(flash_max_abs_err=0.0, decode_max_abs_err=0.0)

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
        flash_cases = [
            ((SERVE_BATCH, SERVE_PROMPT, KV, G, HD), 0, "qwen3 serve"),
            ((2, SERVE_PROMPT, KV, G, HD), 512, "qwen3 window 512"),
            ((1, 300, 1, 4, 64), 0, "ragged"), ((2, 257, 2, 1, 128), 64,
                                                 "ragged window"),
            ((1, 512, 4, 2, 64), 64, "multi-tile window"),
            ((2, 200, 2, 2, 16), 0, "hd 16"), ((1, 100, 2, 3, 256), 7,
                                               "hd 256 window"),
            ((SERVE_BATCH, SERVE_PROMPT, 32, 1, 112), 0, "zamba2 serve"),
            ((2, 300, 2, 2, 112), 64, "hd 112 ragged window")]
        decode_cases = [
            ((SERVE_BATCH, serve_cache, KV, G, HD), v, f"qwen3 valid {v}")
            for v in (1, 7, 1000, SERVE_PROMPT, serve_cache)] + [
            ((1, 600, 1, 1, 128), 520, "empty splits"),
            ((2, 100, 1, 8, 64), 1, "G 8 single slot"),
            ((1, 1000, 2, 2, 64), 999, "ragged"),
            ((1, 64, 2, 3, 16), 64, "hd 16 G 3 full"),
            ((1, 300, 1, 1, 256), 77, "hd 256")] + [
            ((SERVE_BATCH, serve_cache, 32, 1, 112), v, f"zamba2 valid {v}")
            for v in (1, SERVE_PROMPT + 1, serve_cache - 1)] + [
            ((2, 100, 2, 3, 112), 77, "hd 112 G 3")]
        for dtype in (torch.float32, torch.bfloat16):
            for i, ((b, s, kh, g, hd), window, tag) in enumerate(flash_cases):
                q = randn((b, s, kh, g, hd), dtype, 3 * i)
                k = randn((b, s, kh, hd), dtype, 3 * i + 1)
                v = randn((b, s, kh, hd), dtype, 3 * i + 2)
                got = ops.flash_attention(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
                want = flash_plain(q, k, v, True, window)
                attn_check("flash", f"{tag} {(b, s, kh, g, hd)} window "
                           f"{window}", got, want, dtype)
                del want
            for i, ((b, c, kh, g, hd), valid, tag) in enumerate(decode_cases):
                q = randn((b, kh, g, hd), dtype, 100 + 3 * i)
                k = randn((b, c, kh, hd), dtype, 101 + 3 * i)
                v = randn((b, c, kh, hd), dtype, 102 + 3 * i)
                k[:, valid:] = 1e9                 # dead slots
                v[:, valid:] = -1e9
                got = ops.decode_attention(q, k, v, valid)
                torch.cuda.synchronize()
                attn_check("decode", f"{tag} {(b, c, kh, g, hd)}", got,
                           decode_plain(q, k, v, valid), dtype)
    _phase("check-attn", check_attn, failures)

    # 12. serve: qwen3-0.6b at full width and depth --------------------------
    def expected_launches(cfg, steps):
        """(B3, B4, B5) launches of one prefill and ``steps`` decode steps:
        one attention kernel per layer (dense) or shared site (hybrid) and
        one B5 per Mamba2 block."""
        if cfg.family == "dense":
            return cfg.n_layers, cfg.n_layers * steps, 0
        sites = cfg.n_layers // cfg.hybrid_attn_every \
            if cfg.family == "hybrid" else 0
        return sites, sites * steps, cfg.n_layers

    def serve_model(cfg):
        """``Server`` with ``cfg`` at full width and depth, seeded weights
        on the card: a first call, then a counted one, which must launch
        the kernels ``expected_launches`` says and give the same tokens.
        Returns the counted call's (B3, B4, B5) launches."""
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        srv = Server(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, eos_id=-1,
                     device=dev)
        srv.init_params(SEED)
        torch.cuda.synchronize()
        n_par = sum(p.numel() for p in srv.model.parameters())
        nbytes = sum(p.numel() * p.element_size()
                     for p in srv.model.parameters())
        print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.dtype}, {n_par} parameters "
              f"({nbytes / 1e9:.3f} GB), seeded in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        tokens = np.random.default_rng(SEED).integers(
            2, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
        first = srv.generate({"tokens": tokens})
        torch.cuda.reset_peak_memory_stats(dev)
        b3.launches = b4.launches = b5.launches = 0
        out = srv.generate({"tokens": tokens})
        got = (b3.launches, b4.launches, b5.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        want = expected_launches(cfg, SERVE_NEW - 1)
        for tag, o in (("first call", first), ("counted call", out)):
            print(f"[serve] {cfg.name} {tag}: batch {SERVE_BATCH} prompt "
                  f"{SERVE_PROMPT}: prefill {1e3 * o['prefill_s']:.2f} ms, "
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
            lg, _ = srv.model.prefill({"tokens": tokens[:1, :64]})
        assert lg.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(
            lg).all())
        return got

    def serve():
        launches["serve_b3"], launches["serve_b4"], _ = serve_model(qwen)
    _phase("serve", serve, failures)

    # 13. serve-check: the kernels against the plain path in one model -----
    def serve_check(cfgs, dtype="float32"):
        """Each of ``cfgs`` (cut in depth, full width) in ``dtype``: prefill
        of 1000 tokens and 4 greedy steps through the kernels, then the same
        tokens through the plain versions on the card. float32: logits to
        1e-4, equal greedy tokens, and decode logits against the prefill of
        the longer prompt (2e-3). bfloat16: logits within 2e-2 + 2e-2 |plain|
        (the attention kernels' bf16 tolerance); whether the plain path would
        pick the same tokens is printed."""
        torch.cuda.empty_cache()
        b, s, steps = 2, 1000, 4
        for cfg in cfgs:
            cfg = dataclasses.replace(cfg, dtype=dtype)
            model = build_model(cfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(SEED))
            prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
                2, cfg.vocab, (b, s)), device=dev)

            def greedy(force=None):
                """Logits of the prefill and each step, and the greedy tokens
                (fed back, or ``force``'s tokens when given)."""
                lg, c = model.prefill({"tokens": prompt}, cache_len=s + steps)
                logits, toks = [lg], []
                for j in range(steps):
                    toks.append(logits[-1][:, -1].argmax(-1)[:, None])
                    feed = toks[-1] if force is None else force[:, j:j + 1]
                    lg, c = model.decode_step(c, {"token": feed,
                                                  "pos": s + j})
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
                print(f"[serve-check] {cfg.n_layers}-layer {dtype} "
                      f"{cfg.name}, prompt {s}, {steps} greedy steps: kernels "
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
                seq = torch.cat([prompt, tk], 1)
                tf = 0.0
                for j in range(1, steps + 1):
                    want, _ = model.prefill({"tokens": seq[:, :s + j]})
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

    # 14. time-attn: B3 and B4 at the serving shapes ------------------------
    def in_turns(tag, kernel, library, plain, reps, plain_reps, rounds=5):
        """Kernel and library call timed in turns, ``rounds`` times each,
        then the plain version once; medians of the device times."""
        k, lib = [], []
        for _ in range(rounds):
            k.append(queued_ms(kernel, reps))
            lib.append(queued_ms(library, reps))
        p = queued_ms(plain, plain_reps)
        queued = all(r[2] for r in k + lib) and p[2]
        print(f"[time-attn] {tag}: kernel ms per round "
              f"{[round(r[0], 5) for r in k]} (host ms per call "
              f"{float(np.median([r[1] for r in k])):.4f}), sdpa ms per "
              f"round {[round(r[0], 5) for r in lib]}, plain {p[0]:.4f} ms; "
              f"every call queued ahead of the device: {queued}", flush=True)
        return (float(np.median([r[0] for r in k])),
                float(np.median([r[0] for r in lib])), p[0])

    def time_flash(tag, kv, g, hd):
        """B3 at a serving prefill (bf16, causal, batch SERVE_BATCH, prompt
        SERVE_PROMPT, ``kv`` kv heads of ``g`` query heads each) against
        SDPA in turns; returns the timing record."""
        dt = torch.bfloat16
        B, S, h = SERVE_BATCH, SERVE_PROMPT, kv * g
        q = randn((B, S, kv, g, hd), dt, 1)
        k, v = randn((B, S, kv, hd), dt, 2), randn((B, S, kv, hd), dt, 3)
        qs = q.reshape(B, S, h, hd).transpose(1, 2).contiguous()
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  enable_gqa=True)
        ms, lib, plain = in_turns(
            f"B3 {tag}", lambda: ops.flash_attention(q, k, v), sdpa,
            lambda: flash_plain(q, k, v), 20, 3)
        lib_err = float((sdpa().transpose(1, 2).reshape(q.shape).float()
                         - ops.flash_attention(q, k, v).float()).abs().max())
        flops = 4 * B * h * (S * (S + 1) // 2) * hd
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        rec_ = dict(ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"[time-attn] B3 {tag} bf16 q {tuple(q.shape)} causal: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain:.3f} ms, sdpa {lib:.4f} ms ({flops / lib / 1e9:.2f} "
              f"TFLOP/s; max |diff| {lib_err:.3g}), bound "
              f"{rec_['bound_ms']:.4f} ms ({rec_['bound_by']}: {flops:.4g} "
              f"FLOPs, {nbytes:.4g} bytes)", flush=True)
        return rec_

    def time_decode(tag, kv, g, hd):
        """B4 at a serving decode step (bf16 cache of serve_cache slots,
        SERVE_PROMPT live) against SDPA with a slot mask in turns."""
        dt = torch.bfloat16
        B, C, valid, h = SERVE_BATCH, serve_cache, SERVE_PROMPT, kv * g
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
        ms, lib, plain = in_turns(
            f"B4 {tag}", lambda: ops.decode_attention(qd, kc, vc, valid),
            sdpa_d, lambda: decode_plain(qd, kc, vc, valid), 50, 20)
        # blocks per row: decode_split's choice against every count
        kf, vf = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        sweep = {n: min(queued_ms(lambda: da.decode_attention_folded(
            qd, kf, vf, valid, splits=n), 50)[0] for _ in range(3))
            for n in range(1, da.MAX_SPLIT + 1)}
        print(f"[time-attn] B4 {tag} ms by blocks per row (best of 3 rounds; "
              f"chosen {da.decode_split(B * kv, valid)[0]}"
              f"): {', '.join(f'{n}: {t:.5f}' for n, t in sweep.items())}",
              flush=True)
        lib_err = float((sdpa_d().reshape(qd.shape).float()
                         - ops.decode_attention(qd, kc, vc, valid).float()
                         ).abs().max())
        nbytes = 2 * B * valid * kv * hd * 2 + 2 * 2 * qd.numel()
        flops = 4 * B * h * valid * hd
        t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        rec_ = dict(ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"[time-attn] B4 {tag} bf16 q {tuple(qd.shape)} cache "
              f"{tuple(kc.shape)} valid {valid}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e9:.3f} TB/s), plain {plain:.3f} ms, sdpa "
              f"{lib:.4f} ms ({nbytes / lib / 1e9:.3f} TB/s; max |diff| "
              f"{lib_err:.3g}), bound {rec_['bound_ms']:.4f} ms "
              f"({rec_['bound_by']}: {nbytes:.4g} bytes)", flush=True)
        return rec_

    def time_attn():
        zkv, zhd = zamba2.n_kv_heads, zamba2.head_dim
        zg = zamba2.n_heads // zkv
        timing["flash"] = time_flash("qwen3", KV, G, HD)
        time_flash("zamba2", zkv, zg, zhd)
        timing["decode"] = time_decode("qwen3", KV, G, HD)
        time_decode("zamba2", zkv, zg, zhd)
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
        print(f"[check-ssd] {tag} {tuple(x.shape)} N {B.shape[-1]}: "
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
        x, _, B, C = ssd_inputs((2, 100, 3, 16, 8), 213)
        cum = torch.linspace(0.0, -500.0, 100, device=dev)[None, :, None] \
            .expand(2, 100, 3).contiguous()             # exp(+500) above
        ssd_check("steep decay", x, cum, B, C)
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
    def ssd_bound(shape):
        """Least time of one B5 launch, two ways. The float32 CUDA-core
        bound: the causal band's operations (scores C_i . B_j once per
        chunk, 2N each; per head a weight, 3 operations, and P multiply-adds)
        over the fp32 peak, against x and out once, cum, B and C once over
        HBM bandwidth. The bound of the kernel's route: three TF32 products
        (3xTF32) for each of the band's multiply-adds at the dense TF32
        tensor-core peak, against the same bytes."""
        bc, q, h, p, n = shape
        pairs = q * (q + 1) // 2
        ops_ = bc * pairs * (2 * n + h * (2 * p + 3))
        mma = 3 * bc * pairs * (2 * n + 2 * h * p)
        nbytes = 4 * bc * q * (2 * h * p + h + 2 * n)
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
            k = [queued_ms(lambda: b5(*args), 20) for _ in range(5)]
            p = queued_ms(lambda: ssd_scan.ssd_intra_plain(*args), 3)
            ms = float(np.median([r[0] for r in k]))
            bounds, ops_, mma, nbytes = ssd_bound(shape)
            (f_ms, f_by), (r_ms, r_by) = bounds["fp32"], bounds["route"]
            print(f"[time-ssd] B5 {cfg.name} {shape}: kernel ms per round "
                  f"{[round(r[0], 5) for r in k]} (host ms per call "
                  f"{float(np.median([r[1] for r in k])):.4f}), median "
                  f"{ms:.4f} ms ({ops_ / ms / 1e9:.2f} TFLOP/s of the band's "
                  f"fp32 operations, {mma / ms / 1e9:.2f} TFLOP/s of 3xTF32 "
                  f"products), plain {p[0]:.3f} ms, library none; bound of "
                  f"the 3xTF32 route {r_ms:.4f} ms ({r_by}: {mma:.4g} TF32 "
                  f"operations, {nbytes:.4g} bytes), fp32 CUDA-core bound "
                  f"{f_ms:.4f} ms ({f_by}: {ops_:.4g} operations); every "
                  f"call queued ahead of the device: "
                  f"{all(r[2] for r in k) and p[2]}", flush=True)
            timing[f"ssd {cfg.name}"] = dict(ms=ms, plain_ms=p[0],
                                             library_ms=None, bound_ms=r_ms,
                                             bound_by=r_by)
        timing["ssd"] = timing[f"ssd {mamba2.name}"]
    _phase("time-ssd", time_ssd, failures)

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
    sys.exit(main())
