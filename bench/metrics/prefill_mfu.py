"""prefill_mfu: model FLOPs of the window's prefills (the configuration's
reference's ``flops``) over the time to their first tokens (host clock),
times the card's bf16 peak, in percent: the whole prefill's share of the
peak, which bounds what a prefill kernel's roofline can claim for
``ttft_p95_ms``."""
from bench import yardstick


def read(ctx):
    t = sum(c.t_first - c.t0 for c in ctx["calls"])
    return 100.0 * len(ctx["calls"]) * ctx["flops"]["prefill"] \
        / (t * yardstick.PEAK_BF16_FLOPS)
