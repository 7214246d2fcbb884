"""Carry the reference's parameters into the port.

``params_from_reference(cfg, tree)`` takes the reference model's parameter
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``), in its
layer-stacked layout (``repro/models/transformer.py:92-121``)::

    embed (vocab, d), final_norm (d,), [unembed (d, vocab)],
    blocks/{ln1, ln2 (L, d),
            attn/{wq (L, d, h, hd), wk, wv (L, d, k, hd), wo (L, h, hd, d),
                  [q_norm, k_norm (L, hd)]},
            mlp/{wi, [wg] (L, d, ff), wo (L, ff, d)}}

and returns the state dict of ``TransformerLM``: the same values under
``blocks.<i>.`` names, one layer per index. Nothing is transposed or
re-laid out; bfloat16 arrays keep their bits.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = ["params_from_reference"]


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: carry the 16-bit words
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(cfg: ModelConfig, tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    if cfg.family != "dense" or cfg.local_global_period:
        raise NotImplementedError(
            f"{cfg.name}: only the dense uniform family is ported (ROADMAP "
            f"queue A item 12)")
    out = {"embed": _tensor(tree["embed"]),
           "final_norm": _tensor(tree["final_norm"])}
    if not cfg.tie_embeddings:
        out["unembed"] = _tensor(tree["unembed"])
    blocks = tree["blocks"]
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        out[pre + "ln1"] = _tensor(blocks["ln1"][i])
        out[pre + "ln2"] = _tensor(blocks["ln2"][i])
        for group in ("attn", "mlp"):
            for name, a in blocks[group].items():
                out[f"{pre}{group}.{name}"] = _tensor(a[i])
    return out
