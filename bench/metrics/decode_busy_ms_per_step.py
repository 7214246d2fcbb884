"""decode_busy_ms_per_step: device-busy milliseconds (union of their
intervals) of the operations launched inside the program's
``serve.decode_step`` spans in the profiled call, over the steps: the card's
share of a decode step, beside ``decode_ms_per_step``'s whole step."""
from bench import spans


def read(ctx):
    tr = ctx["trace"]
    if not tr or "program_spans" not in tr:
        return None
    steps = spans.count(tr["program_spans"], "serve.decode_step")
    ops = spans.launched_inside(tr, ["serve.decode_step"])
    return spans.busy_ms(ops) / steps if steps and ops else None
