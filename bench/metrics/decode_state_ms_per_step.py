"""decode_state_ms_per_step: device-busy milliseconds of the operations
launched inside the program's ``mamba.state`` (the float32 state update and
read-out) and ``mamba.store`` (the states' copies into the caches) spans
within its ``serve.decode_step`` spans in the profiled call, over the
steps."""
from bench import spans


def read(ctx):
    tr = ctx["trace"]
    if not tr or "program_spans" not in tr:
        return None
    steps = spans.count(tr["program_spans"], "serve.decode_step")
    ops = spans.launched_inside(tr, ["serve.decode_step"],
                                ["mamba.state", "mamba.store"])
    return spans.busy_ms(ops) / steps if steps and ops else None
