"""The hook through which ``launch.analysis.trace_step`` sees a kernel call.

Each kernel's dispatch (``flash_attention_folded``,
``decode_attention_folded``, ``ssd_intra_folded``) runs its route through
``kernel_call``. Outside a trace that is the route itself. Inside one the
counter records a single call of the kernel with its module's analytic
``cost`` and its outputs, and hides the route's own operators and
temporaries, so a call counts the same on the CPU (the plain version), on
the card (the kernel) and on ``meta`` (shapes only).
"""
from __future__ import annotations

#: the active step counter (``launch.analysis``), or None
TRACER = None


def kernel_call(name, run, cost, *args, **kwargs):
    """``run(*args, **kwargs)``, counted under a trace as one call of the
    kernel ``name`` whose work is ``cost(*args, **kwargs)``."""
    if TRACER is None:
        return run(*args, **kwargs)
    return TRACER.kernel(name, run, cost, args, kwargs)
