"""decode_ms_per_step: the served program's own decode clock
(``Server.generate``'s ``decode_s``) summed over the window's calls, over
the decode steps they ran."""


def read(ctx):
    steps = sum(c.steps for c in ctx["calls"])
    return sum(c.decode_s for c in ctx["calls"]) / steps * 1e3 if steps \
        else None
