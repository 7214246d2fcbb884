"""idle_share: the share of the traced call (``bench.generate``) in which
no operation ran on the device, in percent."""
from bench import yardstick


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["kernels"]:
        return None
    busy = yardstick.union_busy((a, b) for _, a, b in tr["kernels"])
    return 100.0 * (1.0 - busy / tr["window_s"])
