"""mfu: model FLOPs of every call the window completed (from the
configuration's shapes: its reference's ``flops``) over the window's length
times the card's bf16 peak, in percent. In a cell of whole equal calls it is
``tokens_per_s`` times a constant; it bounds what a kernel's roofline can
claim end to end."""
from bench import yardstick


def read(ctx):
    f = ctx["flops"]
    total = len(ctx["calls"]) * (f["prefill"] + f["decode"])
    return 100.0 * total / (ctx["window_s"] * yardstick.PEAK_BF16_FLOPS)
