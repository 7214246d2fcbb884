#!/usr/bin/env python3
"""Drive the PyTorch port's planner on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero with no
result line):

  1. build   — compile every CUDA kernel of the main path from
               ``src/repro_torch/kernels/csrc`` with nvcc;
  2. check   — each kernel against its plain PyTorch version on CUDA
               tensors, for seeded random swarms: resnet101 on the paper
               fleet (both fidelity modes), the paper's Fig. 8 problem
               (30 resnet101 copies, 10,140 layers), and one fleet bucket
               of 8 zoo DNNs; ``feasible`` exact, costs rtol 1e-5;
  3. time    — the kernel and its plain version at the Fig. 8 shape;
  4. plan    — the main path: ``plan_offload_batch`` for qwen3-0.6b's
               serving shapes, as ``python -m repro_torch.launch.plan``;
  5. fig8    — ``run_pso_ga`` on the Fig. 8 problem at the paper's
               settings, no worse than ``greedy_offload``'s plan.

Kernel launch counters are zeroed just before each solve path and read
just after; every solve's plans are replayed by the numpy oracle
``simulate_np``. The last lines are the kernels' JSON summary, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
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
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def bound_ms(pp, P, faithful):
    """Least time for one replay of P particles on ``pp`` (one problem):
    the larger of bytes moved over HBM bandwidth and f32 operations over
    the non-tensor f32 peak, counted from this problem's real layers and
    edges."""
    L = int((pp.order >= 0).sum())
    E = int((pp.parent_idx >= 0).sum())
    S, A = pp.max_servers, int(pp.deadline.shape[-1])
    max_p, max_in, max_out = pp.max_layers, pp.parent_idx.shape[-1], \
        pp.child_idx.shape[-1]
    nbytes = (P * max_p * 4                          # genes
              + max_p * 4 * 4                        # order/compute/app/pin
              + max_p * (max_in + max_out) * 8       # relatives, MBs
              + A * 4 + S * 8 + S * S * 9            # deadline, servers
              + P * 9)                               # outputs
    per_edge = 4 if faithful else 6                  # tt, max, [end+tt, gate],
    #                                                  tran*mb, sum
    ops = P * (L * 9 + E * (per_edge + 2) + 3 * S + 2 * A + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.core as port
    from repro_torch.core.batch import SYNC_EVERY
    from repro_torch.core.simulator import kernel_args
    from repro_torch.kernels import _build, schedule_sim
    from repro_torch.core.paper import PAPER_PSO, fig8_problem

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    failures = []
    replay = schedule_sim.schedule_replay
    rec = {"max_abs_err": 0.0}

    # 1. build ------------------------------------------------------------
    def build():
        t0 = time.perf_counter()
        path = _build.build("schedule_sim")
        print(f"[build] {path.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.2f} s")
        print(_build.build_log("schedule_sim") or "(cached)")
        schedule_sim._lib()
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

    def compare(tag, ppb, X, faithful):
        got = replay(*kernel_args(ppb), X, faithful=faithful)
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
        pp8 = port.pad_problem(fig8_prob, device=dev)
        X8 = torch.as_tensor(random_swarm(rng, fig8_prob, 100,
                                          fig8_prob.num_layers), device=dev)
        compare("fig8 corrected", port.stack_problems([pp8]), X8[None],
                False)
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

    def time_kernel():
        ppb, X = plan_bucket()
        args = kernel_args(ppb)
        kernel = cuda_ms(lambda: replay(*args, X, faithful=False), 50)
        plain = cuda_ms(lambda: schedule_sim.schedule_replay_plain(
            *args, X, faithful=False), 5)
        print(f"[time] qwen3-0.6b plan bucket X {tuple(X.shape)} corrected: "
              f"kernel {kernel:.4f} ms  plain {plain:.2f} ms", flush=True)
        ppb = port.stack_problems([port.pad_problem(fig8_prob, device=dev)])
        X = torch.as_tensor(random_swarm(rng, fig8_prob, 100,
                                         fig8_prob.num_layers),
                            device=dev)[None]
        args = kernel_args(ppb)
        kernel = cuda_ms(lambda: replay(*args, X, faithful=False), 20)
        plain = cuda_ms(lambda: schedule_sim.schedule_replay_plain(
            *args, X, faithful=False), 2)
        bms, by = bound_ms(ppb, 100, faithful=False)
        timing.update(ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by)
        print(f"[time] fig8 corrected P=100 x {fig8_prob.num_layers} "
              f"layers: kernel {kernel:.4f} ms  plain {plain:.2f} ms  "
              f"bound {bms:.6f} ms ({by})", flush=True)
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

    def plan():
        replay.launches = 0
        t0 = time.perf_counter()
        plans = port.plan_offload_batch(
            [(get("qwen3-0.6b"), s, DEADLINE_RATIO) for s in shapes],
            env=tpu_env, pso=DEFAULT_PSO, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["plan"] = replay.launches
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

    # 5. fig8 at the paper's settings -------------------------------------
    def fig8():
        cfg = PAPER_PSO
        replay.launches = 0
        t0 = time.perf_counter()
        res = port.run_pso_ga(fig8_dag, fig8_env, cfg, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["fig8"] = replay.launches
        t1 = time.perf_counter()
        greedy = port.greedy_offload(fig8_dag, fig8_env)
        g_wall = time.perf_counter() - t1
        print(f"[fig8] PSO-GA: cost {res.best_cost:.6g} feasible "
              f"{res.feasible} iterations {res.iterations} in {wall:.2f} s "
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

    jax_loaded = "jax" in sys.modules
    print(f"[imports] jax loaded: {jax_loaded}")
    if jax_loaded:
        failures.append("imports")
    if failures:
        print(f"chip_smoke: FAILED phases: {', '.join(failures)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "schedule_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/schedule_sim.cu",
        "replaces": "src/repro/kernels/schedule_sim.py:58",
        "launches": launches["plan"],
        "max_abs_err": rec["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}))
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
