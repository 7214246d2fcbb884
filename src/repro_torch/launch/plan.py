"""Plan the placement of one architecture's serving shapes over the
TPU-fleet environment with one batched PSO-GA fleet — the port's
counterpart of ``repro.launch.serve --plan`` (its planning block only).

    PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen3-0.6b

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

from ..configs import SHAPES, get
from ..core import PSOGAConfig, plan_offload_batch, tpu_fleet_environment

#: the serve planner's settings (``repro/launch/serve.py``)
DEADLINE_RATIO = 1.5
DEFAULT_PSO = PSOGAConfig(pop_size=48, max_iters=200, stall_iters=40)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--pop", type=int, default=DEFAULT_PSO.pop_size)
    ap.add_argument("--iters", type=int, default=DEFAULT_PSO.max_iters)
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    shapes = [s for s in SHAPES if s.kind != "train"]
    pso = PSOGAConfig(pop_size=args.pop, max_iters=args.iters,
                      stall_iters=DEFAULT_PSO.stall_iters)
    t0 = time.perf_counter()
    plans = plan_offload_batch([(cfg, s, DEADLINE_RATIO) for s in shapes],
                               env=tpu_fleet_environment(), pso=pso,
                               device=args.device)
    wall = time.perf_counter() - t0
    for shape, plan in zip(shapes, plans):
        print(f"[plan] PSO-GA fleet placement for {shape.name} "
              f"(backend={plan.backend}):")
        print(plan.summary())
    print(f"[plan] {len(plans)} shapes planned in {wall:.3f} s")


if __name__ == "__main__":
    main()
