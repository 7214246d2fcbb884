"""Where a planning solve's, a served batch's or a train step's time goes
on the card: host wall clock, device kernel time by name
(``torch.profiler``), and the share of the wall during which the device
ran no kernel.

    PYTHONPATH=src python -m repro_torch.launch.breakdown [--traffic bursty]
    PYTHONPATH=src python -m repro_torch.launch.breakdown --serve \
        [--arch mamba2-2.7b | zamba2-7b | gemma3-27b | ...]
    PYTHONPATH=src python -m repro_torch.launch.breakdown --train

Profiles two solves after a warm-up of each: the qwen3-0.6b serving plan
(``launch/plan.py``'s settings) and the paper's Fig. 8 problem at the
paper's PSO-GA settings; with ``--traffic SCENARIO`` also the qwen3-0.6b
plan under that request stream (``launch/plan.py --traffic``, rate 0.5).
``--serve`` profiles the LM server instead, at the batch ``chip_smoke.py``
serves: the prefill of 8 prompts of 2048 tokens and the 31 decode steps
after it (``launch/serve.py``, seeded weights, full width and depth) for
``--arch`` (qwen3-0.6b unless told; mamba2-2.7b and zamba2-7b run their
Mamba2 prefill through B5; the VLM's prompt is its 1,024 vision
embeddings and 1,024 tokens, whisper's 1,500 frames and 187 tokens;
models that do not fit the card at full depth, mixtral-8x7b and
arctic-480b, do not fit here either). ``--train`` profiles one train step
(forward, backward and AdamW through ``launch.steps.make_train_objects``,
seeded weights, full width and depth) of ``--arch`` at ``chip_smoke.py``'s
train shape, batch 4 x 4,096 tokens of the data stream. Prints one JSON
line per profiled run; chrome traces go to ``--trace-dir`` when given.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from ..configs import SHAPES, get
from ..core import (TRAFFIC_KINDS, TrafficConfig, plan_offload_batch,
                    run_pso_ga, tpu_fleet_environment)
from ..core.paper import PAPER_PSO, fig8_problem
from ..kernels import (decode_attention, flash_attention, schedule_sim,
                       ssd_scan, traffic_sim)
from .plan import DEADLINE_RATIO, DEFAULT_PSO
from ..models import CROSS_FRAMES
from .serve import Server, request_batch

#: the served batch: 8 prompts of 2048 tokens, 32 new tokens each
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
#: each kernel's device symbols (a regular expression) and the dispatch that
#: counts its launches; a B1 or B2 call is two kernels (the carry-free pass
#: and the walk), B3 has two bf16 tensor-core kernels (wgmma at head_dim 64,
#: 112 and 128, mma.sync at 16 and 256) and a float32 kernel, a B4 call is
#: the streaming kernel and, where blocks share a row, the merge kernel, B5
#: has a wgmma kernel (P 64, N 64 or 128) and an mma.sync one
KERNELS = {
    "replay": (r"schedule_(step|walk)_kernel", schedule_sim.schedule_replay),
    "traffic": (r"traffic_(step|walk)_kernel", traffic_sim.traffic_replay),
    "flash": (r"flash_(bf16_(wg)?mma|f32)_kernel",
              flash_attention.flash_attention_folded),
    "decode": (r"decode_(tma|merge)_kernel",
               decode_attention.decode_attention_folded),
    "ssd": (r"ssd_(wg)?mma_kernel", ssd_scan.ssd_intra_folded),
}


def profile(tag: str, solve: Callable[[], object],
            trace_dir: Optional[Path]) -> dict:
    """Run ``solve`` once to warm up, then once under the profiler."""
    solve()
    torch.cuda.synchronize()
    for _, dispatch in KERNELS.values():
        dispatch.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (ev.count, dev_us / 1e3)
    busy_ms = sum(ms for _, ms in kernels.values())

    def by_name(name):
        return sum(ms for k, (_, ms) in kernels.items() if re.search(name, k))

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / f"{tag}.json"))
    out = {"run": tag, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (wall * 1e3)}
    for key, (symbol, dispatch) in KERNELS.items():
        ms, n = by_name(symbol), dispatch.launches
        out.update({f"{key}_kernel_ms": ms,        # per counted call
                    f"{key}_ms_per_launch": ms / n if n else None,
                    f"{key}_launches": n})
    out.update(device_kernels=len(kernels),
               top=[{"kernel": k[:80], "count": c, "ms": ms}
                    for k, (c, ms) in top])
    return out


def profile_serve(arch: str, trace_dir: Optional[Path]) -> None:
    """The LM server's prefill, then its decode steps, each profiled."""
    import numpy as np
    cfg = get(arch)
    prompt = CROSS_FRAMES if cfg.family == "encdec" else SERVE_PROMPT
    srv = Server(cfg, SERVE_BATCH, prompt, SERVE_NEW, eos_id=-1)
    srv.init_params(0)
    batch = request_batch(cfg, SERVE_BATCH, prompt, np.random.default_rng(0),
                          vision_tokens=cfg.vision_tokens)
    state = {}

    @torch.inference_mode()
    def prefill():
        state["logits"], state["caches"] = srv.model.prefill(
            batch, cache_len=srv.cache_len)

    @torch.inference_mode()
    def decode():
        tok = state["logits"][:, -1].argmax(-1)[:, None]
        for i in range(SERVE_NEW - 1):
            logits, _ = srv.model.decode_step(
                state["caches"], {"token": tok, "pos": prompt + i})
            tok = logits[:, -1].argmax(-1)[:, None]
            tok.cpu()                  # the server reads every token back

    tag = f"serve-{arch}-b{SERVE_BATCH}-s{prompt}"
    print(json.dumps(profile(f"{tag}-prefill", prefill, trace_dir)))
    print(json.dumps(profile(f"{tag}-decode{SERVE_NEW - 1}", decode,
                             trace_dir)))


#: the train step's shape: train_4k's sequence, its batch cut to 4
TRAIN_BATCH, TRAIN_SEQ = 4, 4096


def profile_train(arch: str, trace_dir: Optional[Path]) -> None:
    """One train step of ``arch`` after a warm-up step."""
    from ..configs.base import ShapeSpec
    from ..data import make_stream
    from ..optim import AdamWConfig, adamw_init
    from .steps import make_train_objects
    cfg = get(arch)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    model, step, _ = make_train_objects(cfg, shape, AdamWConfig())
    model.init(torch.Generator(device=model.device).manual_seed(0))
    state = {"opt": adamw_init(dict(model.named_parameters()))}
    batch = make_stream(cfg, shape).batch(0)

    def run():
        state["opt"], m = step(state["opt"], batch)
        float(m["loss"])

    print(json.dumps(profile(f"train-{arch}-b{TRAIN_BATCH}-s{TRAIN_SEQ}",
                             run, trace_dir)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="the planned arch; with --serve the served one "
                         "(any config that fits the card at full depth)")
    ap.add_argument("--trace-dir", type=Path, default=None)
    ap.add_argument("--traffic", default=None, metavar="SCENARIO",
                    choices=TRAFFIC_KINDS,
                    help="also profile the plan under this arrival family")
    ap.add_argument("--serve", action="store_true",
                    help="profile the LM server's prefill and decode "
                         "instead of the planner")
    ap.add_argument("--train", action="store_true",
                    help="profile one train step instead of the planner")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[breakdown] {smi} torch {torch.__version__}")
    if args.serve:
        profile_serve(args.arch, args.trace_dir)
        return
    if args.train:
        profile_train(args.arch, args.trace_dir)
        return

    cfg, env = get(args.arch), tpu_fleet_environment()
    requests = [(cfg, s, DEADLINE_RATIO) for s in SHAPES if s.kind != "train"]
    print(json.dumps(profile(f"plan-{args.arch}", lambda: plan_offload_batch(
        requests, env=env, pso=DEFAULT_PSO), args.trace_dir)))
    if args.traffic:
        tc = TrafficConfig(kind=args.traffic, rate=0.5)
        print(json.dumps(profile(
            f"plan-{args.arch}-{args.traffic}", lambda: plan_offload_batch(
                requests, env=env, pso=DEFAULT_PSO, traffic=tc),
            args.trace_dir)))

    dag8, env8 = fig8_problem()
    print(json.dumps(profile("fig8", lambda: run_pso_ga(dag8, env8, PAPER_PSO),
                             args.trace_dir)))


if __name__ == "__main__":
    main()
