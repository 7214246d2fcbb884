"""Fault-tolerant trainer (single process): the port of
``repro/launch/train.py``.

Wires the training layers together: the data stream (stateless, so a
restart resumes it exactly), the train step of ``launch.steps`` (forward
and backward on the models' differentiable route, AdamW, optional
micro-batch accumulation and int8 error-feedback compression), async
checkpoints (atomic, keep-N), failure injection with restart supervision
(``runtime.run_with_restarts``) and straggler detection.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --device cpu --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 8 --batch 4 --seq 4096 --ckpt-dir ckpt --ckpt-every 4

Training runs on the card unless ``--device cpu``. It runs no hand-written
kernel, as the reference trains on none of its Pallas kernels: attention
goes through the chunked online softmax and the SSD through its einsum
form, both differentiable (B3, B4 and B5 have no backward and refuse
inputs that require grad). Parameters start from a seeded
``torch.Generator`` draw, or from ``init_params`` (a state dict: how the
parity tests start from the reference's ``model.init(PRNGKey(seed))``).
The reference's device mesh (``--model-axis`` other than 1, its elastic
mesh and ZeRO-1 sharding) waits for ROADMAP queue A item 13c (the models
themselves run on a mesh: ``models.build_model(mesh=)``, item 13b).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get
from ..configs.base import ModelConfig, ShapeSpec
from ..core.device import resolve_device
from ..data import DataConfig, make_stream
from ..optim import (AdamWConfig, CompressionState, OptState, adamw_init,
                     init_compression)
from ..runtime import FailureInjector, StragglerDetector, run_with_restarts
from .steps import make_train_objects

__all__ = ["TrainerConfig", "Trainer", "main", "parse_args",
           "trainer_from_args"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep_n: int = 3
    accum: int = 1
    compress_grads: bool = False
    log_every: int = 10
    seed: int = 0
    model_axis: int = 1              # tensor-parallel degree: 1 only


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 tcfg: TrainerConfig = TrainerConfig(),
                 acfg: AdamWConfig = AdamWConfig(),
                 data: DataConfig = DataConfig(),
                 injector: Optional[FailureInjector] = None,
                 device=None,
                 init_params: Optional[Mapping[str, torch.Tensor]] = None):
        if tcfg.model_axis != 1:
            raise NotImplementedError(
                f"model_axis={tcfg.model_axis}: tensor parallelism over a "
                f"device mesh (the Trainer on a mesh, ZeRO-1) is ROADMAP "
                f"queue A item 13c")
        self.cfg, self.shape, self.tcfg, self.acfg = cfg, shape, tcfg, acfg
        self.device = resolve_device(device)
        self.stream = make_stream(cfg, shape, data)
        self.injector = injector or FailureInjector()
        self.straggler = StragglerDetector()
        self.mgr = (CheckpointManager(tcfg.ckpt_dir, keep_n=tcfg.keep_n)
                    if tcfg.ckpt_dir else None)
        self.metrics_log: list = []
        self.init_params = init_params
        self.model, self._step, _ = make_train_objects(
            cfg, shape, acfg, accum=tcfg.accum,
            compress=tcfg.compress_grads, device=self.device)
        self.params = dict(self.model.named_parameters())

    # ------------------------------------------------------------- state
    def init_state(self):
        """Fresh parameters (``init_params``, or a draw seeded with
        ``tcfg.seed``) and optimiser state."""
        if self.init_params is not None:
            self.model.load_state_dict(self.init_params)
        else:
            self.model.init(torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed))
        opt = adamw_init(self.params)
        if self.tcfg.compress_grads:
            opt = (opt, init_compression(self.params))
        return opt

    def _restore(self, step: int):
        tree = self.mgr.restore(step)
        self.model.load_state_dict(tree["params"])
        o = tree["opt"]

        def dev(d):
            return {n: t.to(self.device) for n, t in d.items()}
        opt = OptState(mu=dev(o["mu"]), nu=dev(o["nu"]),
                       count=o["count"].to(self.device))
        if self.tcfg.compress_grads:
            opt = (opt, CompressionState(error=dev(tree["comp"])))
        return opt

    def _save(self, step: int, opt, blocking: bool = False) -> None:
        if self.mgr is None:
            return
        comp = None
        if self.tcfg.compress_grads:
            opt, comp = opt
        tree = {"params": self.model.state_dict(),
                "opt": {"mu": opt.mu, "nu": opt.nu, "count": opt.count}}
        if comp is not None:
            tree["comp"] = comp.error
        self.mgr.save(step, tree, blocking=blocking)

    def _latest(self) -> Optional[int]:
        """The last checkpoint written, after any write in flight."""
        if self.mgr is None:
            return None
        self.mgr.wait()
        return self.mgr.latest_step()

    # -------------------------------------------------------------- train
    def train(self, max_restarts: int = 5,
              on_step: Optional[Callable[[int, Any], None]] = None
              ) -> Dict[str, Any]:
        """Run to ``tcfg.steps``, restarting from the latest checkpoint after
        a failure. ``on_step(step, opt)`` is called before each step runs,
        with the state entering it (the model holds the parameters)."""
        def body(start_step: int) -> int:
            if start_step > 0 and self.mgr is not None:
                opt = self._restore(start_step - 1)
            else:
                opt = self.init_state()
            step = start_step
            for batch in self.stream.at(start_step):
                if step >= self.tcfg.steps:
                    break
                self.injector.maybe_fail(step)
                if on_step is not None:
                    on_step(step, opt)
                t0 = time.perf_counter()
                opt, m = self._step(opt, batch)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                slow = self.straggler.update(dt)
                if step % self.tcfg.log_every == 0 or slow:
                    rec = {"step": step, "loss": float(m["loss"]),
                           "lr": float(m["lr"]),
                           "grad_norm": float(m["grad_norm"]),
                           "dt": dt, "straggler": slow}
                    self.metrics_log.append(rec)
                    print(f"[train] step {step} loss {rec['loss']:.4f} "
                          f"gnorm {rec['grad_norm']:.3f} {dt * 1e3:.0f}ms"
                          + (" STRAGGLER" if slow else ""), flush=True)
                if (self.mgr is not None
                        and step % self.tcfg.ckpt_every == 0):
                    self._save(step, opt)
                step += 1
            if self.mgr is not None:
                self._save(step - 1, opt, blocking=True)
            self._final = opt
            return step - 1

        final = run_with_restarts(body, self._latest,
                                  max_restarts=max_restarts)
        return {"final_step": final, "metrics": self.metrics_log,
                "stragglers": self.straggler.flagged}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def trainer_from_args(args: argparse.Namespace) -> Trainer:
    """The ``Trainer`` the CLI runs for ``args``: a ``--seq`` x ``--batch``
    train shape, warmup over a tenth of the steps, a cosine decay to
    ``--steps``, failures injected before the ``--fail-at`` steps."""
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, accum=args.accum,
                         compress_grads=args.compress_grads,
                         log_every=args.log_every,
                         model_axis=args.model_axis)
    acfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1))
    inj = FailureInjector(fail_at=tuple(args.fail_at))
    return Trainer(cfg, shape, tcfg, acfg, injector=inj, device=args.device)


def main(argv=None) -> None:
    out = trainer_from_args(parse_args(argv)).train()
    print(f"[train] done: final_step={out['final_step']} "
          f"stragglers={out['stragglers']}")


if __name__ == "__main__":
    main()
