"""prefill_glue_ms: device milliseconds of the traced call's prefill spent
in kernels that are neither B3, nor B5, nor the matrix-multiply library:
the Mamba2 blocks' element-wise, conv, scan and layout glue. The prefill
runs from the ``bench.prefill`` span's start to the first
``bench.decode_step`` span's start."""
import re

#: kernels that are not glue: B3, B5, and cuBLAS / CUTLASS matrix multiplies
NOT_GLUE = re.compile(r"flash_(bf16_(wg)?mma|f32)_kernel|ssd_(wg)?mma_kernel"
                      r"|gemm|nvjet|cutlass|xmma|cublas|s16816|s1688")


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    spans = tr["spans"]
    lo = next((a for n, a, _ in spans if n == "bench.prefill"), None)
    hi = min((a for n, a, _ in spans if n == "bench.decode_step"),
             default=tr["window_s"])
    if lo is None:
        return None
    glue = [b - a for n, a, b in tr["kernels"]
            if lo <= a < hi and not NOT_GLUE.search(n)]
    return sum(glue) * 1e3 if glue else None
