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
telemetry; ``--plan --mesh host`` shards every solve over a device mesh
(``launch/plan.py``). The LM server itself runs on one device (a server on
a mesh is ROADMAP queue A item 13b).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import get
from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..models import build_model
from .plan import add_plan_args, check_plan_args, plan_from_args

__all__ = ["Server", "main", "request_batch"]


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
    unless told). ``self.model`` holds the weights: ``init_params`` draws
    them from a seed, or ``self.model.load_state_dict`` loads them."""

    def __init__(self, cfg: ModelConfig, batch: int, prompt_len: int,
                 max_new: int, eos_id: int = 1, device=None):
        self.cfg = cfg
        self.eos = eos_id
        self.max_new = max_new
        self.batch = batch
        self.prompt_len = prompt_len
        self.cache_len = prompt_len + max_new
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)

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
        wall clocks."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(batch, cache_len=self.cache_len)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        out_tokens = [tok.cpu().numpy()]          # waits for the prefill
        t_prefill = time.perf_counter() - t0

        done = np.zeros((self.batch,), bool)
        t0 = time.perf_counter()
        n_gen = 1
        for i in range(self.max_new - 1):
            logits, caches = self.model.decode_step(
                caches, {"token": tok, "pos": self.prompt_len + i})
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
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
    if (args.trace_out or args.metrics_out) and not args.plan:
        ap.error("--trace-out / --metrics-out instrument the planning "
                 "path: they require --plan")
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
                 device=device)
    srv.init_params()
    batch = request_batch(cfg, args.batch, args.prompt_len,
                          np.random.default_rng(0))
    out = srv.generate(batch)
    print(f"[serve] {cfg.name} on {device}: prefill "
          f"{out['prefill_s'] * 1e3:.0f}ms  decode {out['tokens_generated']} "
          f"tokens in {out['decode_s'] * 1e3:.0f}ms "
          f"({out['decode_tok_per_s']:.1f} tok/s)")
    print("[serve] first row:", out["tokens"][0][:16])


if __name__ == "__main__":
    main()
