"""Batched LM serving loop: prefill a request batch, decode greedily, track
per-slot completion — the port of ``repro/launch/serve.py``'s ``Server``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --plan --traffic bursty
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --plan --serve congestion --chaos --plan-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
        --reduced --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch mixtral-8x7b --model-axis 4

Static slot batching, as in the reference: a batch of B same-length
prompts is prefilled together, then decoded in lock-step at one shared
cache position ``prompt_len + i``; the loop stops when every slot has
emitted EOS or after ``max_new`` tokens. Every family ``build_model``
builds is served alike: the dense transformer (qwen3-0.6b, starcoder2-3b,
gemma-7b, gemma3-27b's local:global layers), MoE (mixtral-8x7b,
arctic-480b), the VLM (internvl2-2b), the enc-dec model (whisper-medium),
the Mamba2 LM (mamba2-2.7b) and the Zamba2 hybrid (zamba2-7b), each also
with the int8 KV cache (``kv_dtype="int8"``). ``request_batch`` builds the
reference ``main``'s synthetic batch: for whisper ``prompt_len`` frames of
audio embeddings and ``prompt_len // 8`` tokens, for the VLM vision
embeddings ahead of the tokens. For whisper the decode positions continue
from ``prompt_len``, the encoder's length, as in the reference. On the
card, self-attention runs through the CUDA kernels B3 (prefill) and B4
(decode) and every Mamba2 block's prefill through B5 (the SSD intra-chunk
form); with ``--device cpu`` their plain versions run. Weights are random,
from a seed.

``--plan`` first plans the serving shapes' placement over the TPU fleet
(``launch/plan.py``), as the reference's ``--plan`` does, then serves;
``--plan --replan SCENARIO`` re-plans them through a drift trace first.
``--plan --serve SCENARIO`` runs the always-on planning service on the
plans instead (``core/service.py``: watchdog, ladder, breaker, triage,
rate estimation, plan cache; ``--chaos`` injects faults) and, like the
reference, returns without serving the LM: it is the serving loop.
``--trace-out`` / ``--metrics-out`` export the planning path's
telemetry; without ``--plan``, ``--trace-out`` exports the serving calls'
spans instead (``Server.generate``'s, and the Mamba2 blocks' and SSD
phases'), all through the process-global channel. ``--plan --mesh host``
shards every solve over a device mesh (``launch/plan.py``).

The LM server runs on one device, or on a device mesh: ``Server(mesh=)``,
or, without one, the reference's ``elastic_mesh(model=model_axis)`` over
the world's ranks when ``model_axis > 1`` or the process is one of
several under ``torchrun`` (``--model-axis N``: a world of W ranks serves
on ``(W / N, N)``). Each rank holds its slices of the model
(``models.build_model(mesh=)``): tensor parallelism over the model axis,
B3, B4 and B5 on the rank's heads, the batch's rows split over the data
axis; every rank returns the same tokens and only rank 0 prints. A batch
of 1 over more than one data shard is served sequence-parallel (the
reference's ``shard_seq``): the prefill runs replicated, each rank keeps
``C/n`` slots of every KV cache (Mamba2 states whole), and each decode
step runs B4 on the rank's live slots and merges the ranks' outputs by
their log-sum-exps (``models.attention.attn_decode``). Outside
``torchrun``, without a mesh and with ``model_axis=1``, the server issues
no collective.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get
from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..core.telemetry import (Telemetry, get_telemetry, maybe_span,
                              telemetry_scope)
from ..models import build_model
from .mesh import data_axes_of
from .plan import (add_plan_args, check_plan_args, export_telemetry,
                   plan_from_args)

__all__ = ["Server", "main", "request_batch", "kernel_launches"]


def kernel_launches() -> tuple:
    """The (B3, B4, B5) launch counters."""
    from ..kernels import decode_attention, flash_attention, ssd_scan
    return (flash_attention.flash_attention_folded.launches,
            decode_attention.decode_attention_folded.launches,
            ssd_scan.ssd_intra_folded.launches)


def request_batch(cfg: ModelConfig, batch: int, prompt_len: int,
                  rng: np.random.Generator,
                  vision_tokens: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
    """The reference ``main``'s request batch from ``rng``: ``prompt_len``
    tokens; for the enc-dec model ``audio_embeds (batch, prompt_len, d)``
    and the first ``prompt_len // 8`` tokens; for the VLM ``vision (batch,
    n, d)`` with ``n = vision_tokens`` (``min(cfg.vision_tokens, 8)``
    unless given) and the first ``prompt_len - n`` tokens."""
    tokens = rng.integers(2, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    if cfg.family == "encdec":
        return {"audio_embeds": rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32),
            "tokens": tokens[:, :prompt_len // 8]}
    if cfg.family == "vlm":
        n = min(cfg.vision_tokens, 8) if vision_tokens is None \
            else vision_tokens
        return {"vision": rng.standard_normal(
            (batch, n, cfg.d_model)).astype(np.float32),
            "tokens": tokens[:, :prompt_len - n]}
    return {"tokens": tokens}


class Server:
    """Greedy batched generation for ``cfg`` on one device (``cuda``
    unless told), or on a device ``mesh`` (without one:
    ``elastic_mesh(model=model_axis)`` over the world when ``model_axis >
    1`` or under a ``torchrun`` of several ranks). ``self.model``
    holds the weights (on a mesh this rank's slices): ``init_params``
    draws them from a seed, or ``self.model.load_state_dict`` loads
    them."""

    def __init__(self, cfg: ModelConfig, batch: int, prompt_len: int,
                 max_new: int, eos_id: int = 1, mesh=None,
                 model_axis: int = 1, device=None):
        self.cfg = cfg
        self.eos = eos_id
        self.max_new = max_new
        self.batch = batch
        self.prompt_len = prompt_len
        self.cache_len = prompt_len + max_new
        self.device = resolve_device(device)
        self.calls = 0                  # generate calls so far
        if mesh is None and (model_axis > 1 or int(
                os.environ.get("WORLD_SIZE", "1")) > 1):
            from ..runtime import elastic_mesh
            mesh = elastic_mesh(model=model_axis, device=self.device)
        self.mesh = mesh
        data_axes = data_axes_of(mesh) if mesh is not None else ("data",)
        self.model = build_model(cfg, device=self.device, mesh=mesh,
                                 data_axes=data_axes)

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Seeded random weights on the model's device; returns its state
        dict."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model.init(gen)
        return self.model.state_dict()

    @torch.inference_mode()
    def generate(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """batch: ``request_batch``'s dict, handed to the model's prefill
        whole. Returns the generated tokens (B, n) and the prefill / decode
        wall clocks. The process-global telemetry (``telemetry_scope``), if
        one is installed, gets the call's spans: ``serve.generate``
        (``call``, this server's sequence number), ``serve.prefill``, a
        ``serve.decode_step`` a step and a ``serve.readback`` around each
        read of the tokens, and from the model's layers theirs."""
        tel = get_telemetry()
        self.calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with maybe_span(tel, "serve.generate", call=self.calls,
                        rows=self.batch, prompt_len=self.prompt_len,
                        max_new=self.max_new):
            t0 = time.perf_counter()
            with maybe_span(tel, "serve.prefill"):
                logits, caches = self.model.prefill(
                    batch, cache_len=self.cache_len)
                tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            with maybe_span(tel, "serve.readback"):
                out_tokens = [tok.cpu().numpy()]  # waits for the prefill
            t_prefill = time.perf_counter() - t0

            done = np.zeros((self.batch,), bool)
            t0 = time.perf_counter()
            n_gen = 1
            for i in range(self.max_new - 1):
                with maybe_span(tel, "serve.decode_step", step=i):
                    logits, caches = self.model.decode_step(
                        caches, {"token": tok, "pos": self.prompt_len + i})
                    tok = logits[:, -1].argmax(dim=-1).to(
                        torch.int32)[:, None]
                    with maybe_span(tel, "serve.readback"):
                        t_np = tok.cpu().numpy()
                out_tokens.append(t_np)
                n_gen += 1
                done |= t_np[:, 0] == self.eos
                if done.all():
                    break
            t_decode = time.perf_counter() - t0
        return {
            "tokens": np.concatenate(out_tokens, axis=1),
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_generated": int(n_gen * self.batch),
            "decode_tok_per_s": (n_gen * self.batch / t_decode
                                 if t_decode > 0 else float("inf")),
        }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="any config: dense (qwen3-0.6b, starcoder2-3b, "
                         "gemma-7b, gemma3-27b), MoE (mixtral-8x7b, "
                         "arctic-480b), VLM (internvl2-2b), enc-dec "
                         "(whisper-medium), SSM (mamba2-2.7b) or hybrid "
                         "(zamba2-7b)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) | cpu: the plain PyTorch path")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="serve on elastic_mesh(model=N) over the world's "
                         "ranks (under torchrun: W ranks serve on (W/N, "
                         "N)); 1 without torchrun: one device, no mesh")
    ap.add_argument("--repeat", type=int, default=1,
                    help="serve the batch this many times (each call "
                         "printed; on the card with each rank's kernel "
                         "launches and peak device memory)")
    ap.add_argument("--plan", action="store_true",
                    help="print the PSO-GA fleet placement first")
    add_plan_args(ap)
    args = ap.parse_args(argv)
    if args.traffic and not args.plan:
        ap.error("--traffic requires --plan")
    if args.replan and not args.plan:
        ap.error("--replan requires --plan")
    if args.serve_scenario and not args.plan:
        ap.error("--serve requires --plan")
    if args.metrics_out and not args.plan:
        ap.error("--metrics-out exports the planning path's metrics: they "
                 "require --plan")
    check_plan_args(ap, args)
    device = resolve_device(args.device)

    cfg = get(args.arch)
    if args.plan:
        plan_from_args(cfg, args, device=device, prefix="serve")
        if args.serve_scenario:
            return                   # the service IS the serving loop
    if args.reduced:
        cfg = cfg.reduced()
    srv = Server(cfg, args.batch, args.prompt_len, args.max_new,
                 model_axis=args.model_axis, device=device)
    mesh = srv.mesh
    srv.init_params()
    batch = request_batch(cfg, args.batch, args.prompt_len,
                          np.random.default_rng(0))
    rank0 = mesh is None or dist.get_rank() == 0
    where = f"{device}" if mesh is None else (
        f"a mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} of "
        f"{dist.get_world_size()} ranks ({dist.get_backend()})")
    # without --plan, --trace-out records the serving calls' spans
    tel = Telemetry() if args.trace_out and not args.plan else None
    for call in range(args.repeat):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        before = kernel_launches()
        with telemetry_scope(tel):
            out = srv.generate(batch)
        launches = [a - b for a, b in zip(kernel_launches(), before)]
        if rank0:
            print(f"[serve] {cfg.name} on {where}, call {call + 1}: prefill "
                  f"{out['prefill_s'] * 1e3:.0f}ms  decode "
                  f"{out['tokens_generated']} tokens in "
                  f"{out['decode_s'] * 1e3:.0f}ms "
                  f"({out['decode_tok_per_s']:.1f} tok/s)")
        if device.type == "cuda":
            rows = [(launches, torch.cuda.max_memory_allocated(device))]
            if mesh is not None:
                from .mesh import gather_objects
                rows = gather_objects(rows[0])
            for r, (n, peak) in enumerate(rows if rank0 else ()):
                print(f"[serve] rank {r}: launches B3 {n[0]} B4 {n[1]} B5 "
                      f"{n[2]}, peak device memory {peak / 1e9:.3f} GB")
    if rank0:
        print("[serve] first row:", out["tokens"][0][:16])
        if tel is not None:
            export_telemetry(tel, args, "serve")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
