"""The training data stream, copied from ``repro.data`` (numpy only)."""
from .pipeline import (DataConfig, SyntheticStream, byte_tokenize,
                       host_slice, make_stream)

__all__ = ["DataConfig", "SyntheticStream", "byte_tokenize", "host_slice",
           "make_stream"]
