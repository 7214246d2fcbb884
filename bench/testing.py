"""Small cells for the CPU tests: a manifest cell cut to a few blocks of a
narrow model and a short batch, whose output check compares every row of
every call. Used by the tests only; the benchmark runs the cells as the
manifest gives them."""
from __future__ import annotations

import copy
import dataclasses

from .harness import Cell, cell

__all__ = ["small_cell"]


def small_cell(workload: str, d: int = 64, layers: int = 2,
               dtype: str = "float32", batch: int = 3, prompt: int = 40,
               new: int = 6) -> Cell:
    """``workload`` at width ``d`` (state 16, head size 16, chunk 16),
    ``layers`` blocks, a vocabulary of 256, in ``dtype``, serving ``batch``
    prompts of ``prompt`` tokens and ``new`` tokens a call."""
    c = cell(workload)
    conf = copy.deepcopy(c.conf)
    conf.update(d_model=d, n_layer=layers, vocab_size=256)
    conf["mamba2"].update(d_state=16, headdim=16, chunk_size=16)
    conf["port"]["fields"].update(n_layers=layers, d_model=d, vocab=256,
                                  ssm_state=16, ssm_head_dim=16,
                                  ssm_chunk=16, dtype=dtype)
    traffic = dataclasses.replace(c.traffic, batch=batch, prompt_len=prompt,
                                  new_tokens=new, check_calls=1 << 20,
                                  check_rows=batch)
    return dataclasses.replace(c, conf=conf, traffic=traffic)
