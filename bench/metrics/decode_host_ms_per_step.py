"""decode_host_ms_per_step: the host's own work a decode step. In the
drained spanned call (the program's telemetry on its host clock, no
profiler, the device's queue emptied before each block's step, so that no
launch waits for the card), the mean time of the program's
``serve.decode_step`` spans less the ``bench.drain`` waits and the
``serve.readback`` inside each. It does not fall when the card gets faster:
it is the step time the host alone would allow."""
from bench import spans


def read(ctx):
    host = ctx.get("program_spans")
    if not host:
        return None
    own = spans.host_self_s(host, "serve.decode_step",
                            ("serve.readback", spans.DRAIN))
    return sum(own) / len(own) * 1e3 if own else None
