"""tokens_per_s: every token the window's traffic processed (prompt tokens
prefilled and tokens generated) over all the time of the window, from its
start to the end of its last call (host clock)."""


def read(ctx):
    return sum(ctx["traffic"].tokens_per_call for _ in ctx["calls"]) \
        / ctx["window_s"]
