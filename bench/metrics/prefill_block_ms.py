"""prefill_block_ms: device-busy milliseconds of the operations launched
inside the program's ``mamba.seq`` spans and outside their ``ssd.chunked``,
within ``serve.prefill``, in the profiled call: the Mamba2 blocks' own work
around the SSD (projections, conv, gates, D skip, gated norm, out
projection)."""
from bench import spans


def read(ctx):
    tr = ctx["trace"]
    if not tr or "program_spans" not in tr:
        return None
    ops = spans.launched_inside(tr, ["serve.prefill"], ["mamba.seq"],
                                outside=["ssd.chunked"])
    return spans.busy_ms(ops) if ops else None
