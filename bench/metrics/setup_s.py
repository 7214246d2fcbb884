"""setup_s: process start to the first timed call: imports, the program's
construction, the seeded weights, the kernels' build on a checkout's first
run, and one warm-up call at the cell's shapes (host clock)."""


def read(ctx):
    return ctx["setup_s"]
