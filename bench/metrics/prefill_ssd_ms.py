"""prefill_ssd_ms: device-busy milliseconds of the operations launched
inside the program's ``ssd.chunked`` spans and outside their ``ssd.intra``
(B5), within ``serve.prefill``, in the profiled call: the chunked SSD's
float32 glue (casts, cumsum, outflow, cross-chunk loop, inflow)."""
from bench import spans


def read(ctx):
    tr = ctx["trace"]
    if not tr or "program_spans" not in tr:
        return None
    ops = spans.launched_inside(tr, ["serve.prefill"], ["ssd.chunked"],
                                outside=["ssd.intra"])
    return spans.busy_ms(ops) if ops else None
