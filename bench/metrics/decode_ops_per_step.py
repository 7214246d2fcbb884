"""decode_ops_per_step: device operations launched inside the program's
``serve.decode_step`` spans in the profiled call, over the steps: the work
the host enqueues a step."""
from bench import spans


def read(ctx):
    tr = ctx["trace"]
    if not tr or "program_spans" not in tr:
        return None
    steps = spans.count(tr["program_spans"], "serve.decode_step")
    ops = spans.launched_inside(tr, ["serve.decode_step"])
    return len(ops) / steps if steps and ops else None
