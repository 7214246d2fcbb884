"""b5_roofline: B5's share of its roofline in the traced call: the least
time its launch could take on the card, max(flops / TF32 peak, bytes / HBM
peak) from the frozen cost (``yardstick.ssd_cost``) at the launch shape the
configuration's reference gives (``ssd_launch_shape``), over its mean device
time a launch, in percent."""
import re

from bench import yardstick

B5 = re.compile(r"ssd_(wg)?mma_kernel")


def read(ctx):
    tr = ctx["trace"]
    times = [b - a for n, a, b in tr["kernels"] if B5.search(n)] if tr \
        else []
    shape_of = getattr(ctx["reference"], "ssd_launch_shape", None)
    if not times or shape_of is None:
        return None
    t = ctx["traffic"]
    cost = yardstick.ssd_cost(*shape_of(ctx["conf"], t.batch, t.prompt_len))
    bound = max(cost["flops"] / yardstick.PEAK_TF32_FLOPS,
                cost["bytes"] / yardstick.PEAK_HBM_BYTES)
    return 100.0 * bound / (sum(times) / len(times))
