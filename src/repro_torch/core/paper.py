"""The paper's §V experiment settings: its PSO-GA parameters and its
largest problem (Fig. 8), as ``benchmarks/common.py::build_problem``
builds it in the reference."""
from __future__ import annotations

import numpy as np

from . import zoo
from .baselines import heft_makespan
from .dag import merge_dags
from .environment import paper_environment
from .pso_ga import PSOGAConfig

__all__ = ["PAPER_PSO", "fig8_problem"]

#: pop 100, 1000 iterations, stop after 50 unchanged (paper §V-C)
PAPER_PSO = PSOGAConfig(pop_size=100, max_iters=1000, stall_iters=50)


def fig8_problem():
    """Paper Fig. 8: three resnet101 per end device on the 20-server
    fleet (10,140 layers, 30 apps), deadlines 3.0 × HEFT × 2."""
    env = paper_environment()
    merged = merge_dags([zoo.build("resnet101", pin_server=d)
                         for d in range(10) for _ in range(3)])
    h, _ = heft_makespan(merged, env)
    return merged.with_deadline(np.full(merged.num_apps, 2.0 * 3.0 * h)), env
