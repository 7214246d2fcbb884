"""The optimiser and gradient compression, ported from ``repro.optim``:
AdamW with float32 moments (``adamw``) and int8 error feedback
(``compression``). ``zero1_pspecs`` waits for ROADMAP queue A item 13c."""
from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    cosine_schedule, global_norm)
from .compression import (CompressionState, compress_error_feedback,
                          dequantize_int8, init_compression, quantize_int8)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "CompressionState",
           "compress_error_feedback", "dequantize_int8", "init_compression",
           "quantize_int8"]
