"""ttft_p95_ms: the 95th percentile, over every request (batch row) of the
window, of the time from the start of its call to its first token on the
host (host clock; the rows of one call share it)."""
import numpy as np


def read(ctx):
    ttft = [(c.t_first - c.t0) * 1e3 for c in ctx["calls"]
            for _ in range(c.rows)]
    return float(np.percentile(ttft, 95))
