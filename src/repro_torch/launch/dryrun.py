"""Multi-pod dry run: the port of ``repro/launch/dryrun.py``. Every (arch x
shape x mesh) cell builds and traces one step of rank 0 of the production
fleet, and the trace gives the roofline's inputs.

The fleet is a fake process group (``torch.testing._internal.distributed.
fake_pg``): 256 ranks, the reference's 16 x 16 mesh, or 512 with
``--multi-pod``; ``REPRO_DRYRUN_DEVICES`` overrides the count, as in the
reference (the tests' 8). Its collectives return at once and move
nothing. The model, its arguments and every activation live on ``meta``:
nothing is allocated and no device is touched, as the reference's
placeholder devices touch none. B3, B4 and B5 take their shape-only route
on ``meta``. ``launch.analysis.trace_step`` counts the step
(``StepCost``) where the reference reads ``compiled.memory_analysis()``,
``cost_analysis()`` and the partitioned HLO.

Where the port's counts differ from XLA's:
- FLOPs are matmul FLOPs (``torch.utils.flop_counter``'s formulas) plus
  the hand-written kernels' analytic ones (each module's ``cost``);
  elementwise operators are not counted.
- Bytes are eager: every operator's inputs read and outputs written, one
  operator at a time, unfused (XLA's fusions keep intermediates on chip).
- Memory is the live storages' high-water mark of the eager step,
  autograd's saved tensors included; ``code_bytes`` is 0.
- A 16-wide model axis spans two 8-GPU NVLink nodes on a real H100 fleet,
  yet is priced at ``HW.ici_bw`` as the reference prices its ICI: that
  term is optimistic.

A decode cell runs at the last position of a full cache (``pos =
seq_len - 1``), so every slot is live. The process must start fresh: the
default process group, once made, is the fake fleet (``run_cell`` raises
on a group of another kind or size).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multi-pod] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out-dir d/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch.distributed as dist

from ..configs import SHAPES, get, names
from ..models import (cache_len_for, input_specs, model_flops, param_count,
                      skip_reason, supports_shape)
from ..optim import adamw_init
from .analysis import HW, collective_bytes, roofline_terms, trace_step
from .mesh import data_axes_of, make_production_mesh, make_test_mesh
from .steps import (make_decode_objects, make_prefill_objects,
                    make_train_objects)

__all__ = ["run_cell", "main", "fake_world"]


def _world_size(multi_pod: bool = False) -> int:
    """The fake fleet's ranks: ``REPRO_DRYRUN_DEVICES``, else 512 with
    ``multi_pod`` and 256 without."""
    env = os.environ.get("REPRO_DRYRUN_DEVICES")
    return int(env) if env else (512 if multi_pod else 256)


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks, this
    process rank 0; a group that exists must be such a one."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(
                f"the dry run needs a fake world of {n} ranks; this process "
                f"has a {dist.get_backend()!r} group of "
                f"{dist.get_world_size()} (run it in a fresh process)")
        return
    # registers the "fake" backend (a private module of torch's tests)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)


def _mem_dict(c) -> Dict[str, float]:
    return {"argument_bytes": float(c.argument_bytes),
            "output_bytes": float(c.output_bytes),
            "temp_bytes": float(c.temp_bytes),
            "alias_bytes": float(c.alias_bytes),
            "code_bytes": 0.0,
            "peak_bytes": float(c.peak_bytes)}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             moe_impl: str = "scatter", accum: int = 1,
             test_mesh: bool = False, extra: Optional[Dict] = None
             ) -> Dict[str, Any]:
    """Build and trace one cell; returns the §Dry-run/§Roofline record."""
    cfg = get(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    if extra:
        cfg = dataclasses.replace(cfg, **{k: v for k, v in extra.items()
                                          if hasattr(cfg, k)})
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "multi_pod": multi_pod, "moe_impl": moe_impl, "accum": accum,
    }
    if not supports_shape(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = skip_reason(cfg, shape)
        return rec

    fake_world(_world_size(multi_pod))
    mesh = (make_test_mesh(multi_pod=multi_pod, device="cpu") if test_mesh
            else make_production_mesh(multi_pod=multi_pod, device="cpu"))
    daxes = data_axes_of(mesh)
    n_chips = mesh.size()
    rec["mesh"] = {a: int(mesh.shape[i])
                   for i, a in enumerate(mesh.mesh_dim_names)}

    t0 = time.time()
    kw = dict(device="meta", mesh=mesh, data_axes=daxes, moe_impl=moe_impl)
    batch = input_specs(cfg, shape)                 # meta tensors
    if shape.kind == "train":
        model, step, _ = make_train_objects(cfg, shape, accum=accum, **kw)
        opt = adamw_init({n: step.plan.zslice(n, p)
                          for n, p in model.named_parameters()})
        args = (opt, batch)
    elif shape.kind == "prefill":
        model, step, _ = make_prefill_objects(cfg, shape, **kw)
        args = (batch,)
    else:
        model, step, _ = make_decode_objects(cfg, shape, **kw)
        caches = model.init_caches(shape.global_batch,
                                   cache_len_for(cfg, shape))
        batch["pos"] = shape.seq_len - 1
        args = (caches, batch)
    live = [*model.parameters(), *model.buffers()]
    _, cost = trace_step(step, *args, live=live)
    t_trace = time.time() - t0

    pod_size = n_chips // int(rec["mesh"]["pod"]) if multi_pod else 0
    coll = collective_bytes(cost.collectives, pod_size=pod_size)
    top = sorted(((c.op, c.result_bytes, len(c.ranks))
                  for c in cost.collectives), key=lambda t: -t[1])[:10]
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "trace_s": round(t_trace, 2),
        "memory": _mem_dict(cost),
        "flops_per_chip": float(cost.flops),
        "hbm_bytes_per_chip": float(cost.bytes),
        "collective": {
            "per_op": coll.per_op, "ici_bytes": coll.total_ici,
            "dcn_bytes": coll.total_dcn, "count": coll.count,
            "top": [{"op": o, "result_bytes": b, "group": g}
                    for o, b, g in top],
        },
        "kernel_calls": cost.kernels_by_name(),
    })
    rec["roofline"] = roofline_terms(cost.flops, cost.bytes, coll)
    mf = model_flops(cfg, shape)
    rec["model_flops_total"] = mf
    rec["model_flops_per_chip"] = mf / n_chips
    rec["useful_compute_ratio"] = (mf / n_chips / cost.flops
                                   if cost.flops else 0.0)
    rec["params_total"] = param_count(cfg)
    rec["params_active"] = param_count(cfg, active_only=True)
    rec["fits_hbm"] = bool(rec["memory"]["peak_bytes"] <= HW().hbm_bytes)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default="scatter",
                    choices=["scatter", "a2a"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--test-mesh", action="store_true",
                    help="scaled-down mesh (CI)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--extra", default=None,
                    help="JSON dict of ModelConfig overrides (perf ablations)")
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume an interrupted matrix run")
    ap.add_argument("--tag", default="",
                    help="suffix for out-dir filenames (e.g. 'roofline')")
    args = ap.parse_args()
    extra = json.loads(args.extra) if args.extra else None

    cells = []
    if args.all:
        for a in names():
            for s in SHAPES:
                cells.append((a, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]

    # the fake fleet, before any function of the port makes a world of one
    fake_world(_world_size(args.multi_pod))
    results = []
    for arch, shape in cells:
        # accumulation applies to train cells only (memory-fit policy)
        accum = args.accum if shape.startswith("train") else 1
        tag = f"{arch}_{shape}_{'mp' if args.multi_pod else 'sp'}" \
            + (f"_{args.tag}" if args.tag else "")
        if args.out_dir and args.skip_existing:
            path = os.path.join(args.out_dir, tag + ".json")
            if os.path.exists(path):
                print(f"[dryrun] {arch} x {shape}: exists, skipped",
                      flush=True)
                continue
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           moe_impl=args.moe_impl, accum=accum,
                           test_mesh=args.test_mesh, extra=extra)
        except Exception as e:  # noqa: BLE001 — record, keep matrix going
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        results.append(rec)
        status = rec["status"]
        extra_txt = ""
        if status == "ok":
            r = rec["roofline"]
            extra_txt = (f" trace={rec['trace_s']}s "
                         f"dominant={r['dominant']} "
                         f"fits_hbm={rec['fits_hbm']}")
        elif status == "skipped":
            extra_txt = f" ({rec['reason']})"
        else:
            extra_txt = f" {rec['error'][:120]}"
        print(f"[dryrun] {arch} x {shape} "
              f"{'pod2' if args.multi_pod else 'pod1'}: "
              f"{status}{extra_txt}", flush=True)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results if len(results) > 1 else results[0], f,
                      indent=1)
    bad = [r for r in results if r["status"] == "error"]
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
