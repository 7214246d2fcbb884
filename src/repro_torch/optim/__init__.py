"""The optimiser and gradient compression, ported from ``repro.optim``:
AdamW with float32 moments and the ZeRO-1 specs of its state
(``adamw``), and int8 error feedback (``compression``)."""
from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    cosine_schedule, global_norm, zero1_pspecs)
from .compression import (CompressionState, compress_error_feedback,
                          dequantize_int8, init_compression, quantize_int8)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "zero1_pspecs",
           "CompressionState", "compress_error_feedback", "dequantize_int8",
           "init_compression", "quantize_int8"]
