"""Fault-tolerant trainer: the port of ``repro/launch/train.py``.

Wires the training layers together: the device mesh (the reference's
elastic mesh), the data stream (stateless, so a restart resumes it
exactly), the train step of ``launch.steps`` (forward and backward on the
models' differentiable route, AdamW with ZeRO-1 state on a mesh, optional
micro-batch accumulation and int8 error-feedback compression), async
checkpoints (atomic, keep-N, mesh-agnostic), failure injection with
restart supervision (``runtime.run_with_restarts``) and straggler
detection.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --device cpu --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 8 --batch 4 --seq 4096 --ckpt-dir ckpt --ckpt-every 4
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch qwen3-0.6b --model-axis 2 \\
        --batch 8 --seq 4096 --steps 6

Training runs on the card unless ``--device cpu``. It runs no hand-written
kernel, as the reference trains on none of its Pallas kernels: attention
goes through the chunked online softmax and the SSD through its einsum
form, both differentiable (B3, B4 and B5 have no backward and refuse
inputs that require grad). Parameters start from a seeded
``torch.Generator`` draw, or from ``init_params`` (a whole state dict: how
the parity tests start from the reference's ``model.init(PRNGKey(seed))``).

On a device mesh (``Trainer(mesh=)``; without one the reference's
``elastic_mesh(model=model_axis)`` over the world's ranks when
``model_axis > 1`` or under a ``torchrun`` of several ranks) each rank
holds its slices of the parameters (tensor parallelism over the model
axis), its ZeRO-1 slices of the moments and, with compression, a residual
shaped as its parameters. Every rank draws the global batch from the
stream and the train step keeps the rank's rows, which is what the
reference's single controller feeds its jitted step (its per-process
``make_stream(process_index=)`` would give every process the same rows,
see ``data.pipeline``). Checkpoints hold whole tensors in the reference's
layout: every rank takes part in gathering each leaf, rank 0 writes, and
a restore on any mesh cuts the rank's slices from the whole leaves; the
ranks agree on the latest step after rank 0's write has landed. Only rank
0 prints, and every rank returns the same metrics (rank 0's step time).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get
from ..configs.base import ModelConfig, ShapeSpec
from ..core.device import resolve_device
from ..data import DataConfig, make_stream
from ..models import shard_state_dict
from ..optim import (AdamWConfig, CompressionState, OptState, adamw_init,
                     init_compression)
from ..runtime import FailureInjector, StragglerDetector, run_with_restarts
from .mesh import agree, data_axes_of
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
    model_axis: int = 1              # TP degree for the elastic mesh


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 tcfg: TrainerConfig = TrainerConfig(),
                 acfg: AdamWConfig = AdamWConfig(),
                 data: DataConfig = DataConfig(),
                 injector: Optional[FailureInjector] = None,
                 device=None,
                 init_params: Optional[Mapping[str, torch.Tensor]] = None,
                 mesh=None):
        self.cfg, self.shape, self.tcfg, self.acfg = cfg, shape, tcfg, acfg
        self.device = resolve_device(device)
        if mesh is None and (tcfg.model_axis > 1 or int(
                os.environ.get("WORLD_SIZE", "1")) > 1):
            from ..runtime import elastic_mesh
            mesh = elastic_mesh(model=tcfg.model_axis, device=self.device)
        self.mesh = mesh
        self.daxes = data_axes_of(mesh) if mesh is not None else ("data",)
        self.rank0 = mesh is None or dist.get_rank() == 0
        self.stream = make_stream(cfg, shape, data)
        self.injector = injector or FailureInjector()
        self.straggler = StragglerDetector()
        self.mgr = (CheckpointManager(tcfg.ckpt_dir, keep_n=tcfg.keep_n)
                    if tcfg.ckpt_dir else None)
        self.metrics_log: list = []
        self.init_params = init_params
        self.model, self._step, _ = make_train_objects(
            cfg, shape, acfg, accum=tcfg.accum,
            compress=tcfg.compress_grads, device=self.device, mesh=mesh,
            data_axes=self.daxes)
        self.plan = self._step.plan
        self.params = dict(self.model.named_parameters())

    # ------------------------------------------------------------- state
    def init_state(self):
        """Fresh parameters (``init_params``, cut to the rank's slices on a
        mesh, or a draw seeded with ``tcfg.seed``) and optimiser state (the
        rank's ZeRO-1 slices of the moments)."""
        if self.init_params is not None:
            state = self.init_params
            if self.mesh is not None:
                state = shard_state_dict(state, self.plan.specs,
                                         self.model.sh)
            self.model.load_state_dict(state)
        else:
            self.model.init(torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed))
        opt = adamw_init({n: self.plan.zslice(n, p)
                          for n, p in self.params.items()})
        if self.tcfg.compress_grads:
            opt = (opt, init_compression(self.params))
        return opt

    def _restore(self, step: int):
        """The state saved at ``step`` (whole tensors), cut to this rank's
        slices of the parameters, moments and residual."""
        tree = self.mgr.restore(step)
        plan, sh = self.plan, self.model.sh
        self.model.load_state_dict(
            shard_state_dict(tree["params"], plan.specs, sh))
        o = tree["opt"]

        def moments(d):
            return {n: t[plan.moments_index(n)].to(self.device)
                    for n, t in d.items()}
        opt = OptState(mu=moments(o["mu"]), nu=moments(o["nu"]),
                       count=o["count"].to(self.device))
        if self.tcfg.compress_grads:
            opt = (opt, CompressionState(error={
                n: t.to(self.device) for n, t in shard_state_dict(
                    tree["comp"], plan.specs, sh).items()}))
        return opt

    def _save(self, step: int, opt, blocking: bool = False) -> None:
        """Whole tensors, written by rank 0. On a mesh every rank takes
        part in gathering each leaf in turn into host memory
        (``MeshPlan.whole``); rank 0 keeps it and the others drop it, so
        no card holds more than one whole leaf beside its slices."""
        if self.mgr is None:
            return
        comp = None
        if self.tcfg.compress_grads:
            opt, comp = opt
        plan = self.plan

        def whole(d, specs):
            out = {}
            for n, t in d.items():
                w = plan.whole(t.detach(), specs[n])
                if self.rank0:
                    out[n] = w
            return out
        tree = {"params": whole(self.model.state_dict(), plan.specs),
                "opt": {"mu": whole(opt.mu, plan.zspecs),
                        "nu": whole(opt.nu, plan.zspecs),
                        "count": opt.count}}
        if comp is not None:
            tree["comp"] = whole(comp.error, plan.specs)
        if self.rank0:
            self.mgr.save(step, tree, blocking=blocking)

    def _latest(self) -> Optional[int]:
        """The last checkpoint written, after any write in flight (on a
        mesh: rank 0's answer, once its write has landed)."""
        if self.mgr is None:
            return None
        self.mgr.wait()
        if self.mesh is None:
            return self.mgr.latest_step()
        dist.barrier()
        return agree(self.mesh, self.mgr.latest_step())

    # -------------------------------------------------------------- train
    def train(self, max_restarts: int = 5,
              on_step: Optional[Callable[[int, Any], None]] = None
              ) -> Dict[str, Any]:
        """Run to ``tcfg.steps``, restarting from the latest checkpoint after
        a failure. ``on_step(step, opt)`` is called before each step runs,
        with the state entering it (the model holds the parameters)."""
        def body(start_step: int) -> int:
            if start_step > 0 and self.mgr is not None:
                t0 = time.perf_counter()
                opt = self._restore(start_step - 1)
                if self.rank0:
                    print(f"[train] restored step {start_step - 1} in "
                          f"{time.perf_counter() - t0:.1f} s", flush=True)
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
                if self.mesh is not None:
                    dt = agree(self.mesh, dt)
                slow = self.straggler.update(dt)
                if step % self.tcfg.log_every == 0 or slow:
                    rec = {"step": step, "loss": float(m["loss"]),
                           "lr": float(m["lr"]),
                           "grad_norm": float(m["grad_norm"]),
                           "dt": dt, "straggler": slow}
                    self.metrics_log.append(rec)
                    if self.rank0:
                        print(f"[train] step {step} loss {rec['loss']:.4f} "
                              f"gnorm {rec['grad_norm']:.3f} "
                              f"{dt * 1e3:.0f}ms"
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
    ap.add_argument("--model-axis", type=int, default=1,
                    help="train on elastic_mesh(model=N) over the world's "
                         "ranks (under torchrun: W ranks train on (W/N, "
                         "N)); 1 without torchrun: one device, no mesh")
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
    trainer = trainer_from_args(parse_args(argv))
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = trainer.train()
    if trainer.rank0:
        print(f"[train] done: final_step={out['final_step']} "
              f"stragglers={out['stragglers']}")
    if dev.type == "cuda":
        peaks = [torch.cuda.max_memory_allocated(dev)]
        if trainer.mesh is not None:
            from .mesh import gather_objects
            peaks = gather_objects(peaks[0])
        for r, peak in enumerate(peaks if trainer.rank0 else ()):
            print(f"[train] rank {r}: peak device memory {peak / 1e9:.3f} "
                  f"GB")
    if trainer.mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
