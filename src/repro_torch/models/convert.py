"""Carry the reference's parameters into the port.

``params_from_reference(cfg, tree)`` takes the reference model's parameter
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``), in its
layer-stacked layout, and returns the state dict of the port's model for
``cfg.family``: the same values under per-block names, one block per index.

* dense, moe, vlm (``repro/models/transformer.py:92-121``)::

      embed (vocab, d), final_norm (d,), [unembed (d, vocab)],
      [vision_proj (d, d)],
      blocks/{ln1, ln2 (L, d),
              attn/{wq (L, d, h, hd), wk, wv (L, d, k, hd), wo (L, h, hd, d),
                    [q_norm, k_norm (L, hd)]},
              mlp/{wi, [wg] (L, d, ff), wo (L, ff, d)}
              | moe/{router (L, d, E) float32, wi, wg (L, E, d, ff),
                     wo (L, E, ff, d), [dense/{wi, wg, wo}]}}

  → ``blocks.<i>.{ln1, ln2, attn.<name>, mlp.<name> | moe.<name>}``; with
  a local:global period the blocks lead with ``(n_groups, period)`` and
  the leftover layers sit under ``tail`` (leading ``n_tail``) →
  ``blocks.<g>.<l>.*``, ``tail.<t>.*``;
* ssm (``repro/models/hybrid.py:50-59``, ``ssm.py:39-57``)::

      embed, final_norm, blocks/{ln (L, d), mamba/{wz, wx, wB, wC, wdt,
                                  conv_w, conv_b, A_log, D, dt_bias, norm,
                                  wo} (L, ...)}

  → ``blocks.<i>.{ln, mamba.<name>}``;
* hybrid (``repro/models/hybrid.py:140-166``): the same mamba blocks under
  ``groups`` (leading ``(n_groups, k)``) and ``tail`` (leading
  ``n_tail``), plus ``shared_attn/{ln1, attn/..., ln2, mlp/...}`` (one
  set) → ``groups.<g>.<l>.*``, ``tail.<t>.*``, ``shared_attn.*``;
* encdec (``repro/models/encdec.py:83-97``): ``enc_blocks/{ln1, attn/...,
  ln2, mlp/...}`` (leading ``enc_layers``), ``dec_blocks/`` the same plus
  ``ln_x``, ``xattn/...`` (leading ``dec_layers``), ``enc_norm``,
  ``dec_norm``, ``embed``, ``dec_pos`` → ``enc_blocks.<i>.*``,
  ``dec_blocks.<i>.*`` and the four by name.

Nothing is transposed or re-laid out; bfloat16 arrays keep their bits and
the float32 ``A_log``, ``D``, ``dt_bias`` and MoE ``router`` of a
bfloat16 model stay float32.

``shard_state_dict(full, specs, sh)`` cuts a whole state dict to one
rank's slices of a model's ``param_pspecs()`` (``sh``, the model's
``Sharding``), which is what a model built on a mesh holds;
``params_from_reference(cfg, tree, model=)`` does it for the reference's
parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = ["params_from_reference", "shard_state_dict"]


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: carry the 16-bit words
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(node: Any, prefix: str, out: Dict[str, torch.Tensor],
             index=()) -> None:
    """Every leaf of ``node`` under ``prefix.<path>``, indexed by
    ``index`` along its leading axes."""
    if isinstance(node, Mapping):
        for k, v in node.items():
            _flatten(v, f"{prefix}.{k}" if prefix else k, out, index)
    else:
        out[prefix] = _tensor(np.asarray(node)[index])


def _stacked(tree: Any, name: str, lead: tuple,
             out: Dict[str, torch.Tensor]) -> None:
    """A layer-stacked subtree with leading axes ``lead`` as
    ``name.<i>[.<j>].<path>``."""
    for idx in np.ndindex(*lead):
        _flatten(tree, ".".join([name, *map(str, idx)]), out, idx)


def shard_state_dict(full: Mapping[str, torch.Tensor],
                     specs: Mapping[str, Any], sh) -> Dict[str, torch.Tensor]:
    """Every tensor of ``full`` cut to this rank's slice of its spec
    (``specs[name]``) on ``sh`` (a ``layers.Sharding``)."""
    return {n: t[sh.index(specs[n], t.shape)].clone()
            for n, t in full.items()}


def params_from_reference(cfg: ModelConfig, tree: Mapping[str, Any],
                          model=None) -> Dict[str, torch.Tensor]:
    """The reference's parameters as the port's state dict; with
    ``model`` (one built on a mesh) this rank's slices of them."""
    state = _whole(cfg, tree)
    if model is None or model.sh.mesh is None:
        return state
    return shard_state_dict(state, model.param_pspecs(), model.sh)


def _whole(cfg: ModelConfig, tree: Mapping[str, Any]
           ) -> Dict[str, torch.Tensor]:
    if cfg.family == "encdec":
        out = {n: _tensor(tree[n])
               for n in ("enc_norm", "dec_norm", "embed", "dec_pos")}
        _stacked(tree["enc_blocks"], "enc_blocks", (cfg.enc_layers,), out)
        _stacked(tree["dec_blocks"], "dec_blocks", (cfg.dec_layers,), out)
        return out
    out = {"embed": _tensor(tree["embed"]),
           "final_norm": _tensor(tree["final_norm"])}
    if cfg.family == "ssm":
        _stacked(tree["blocks"], "blocks", (cfg.n_layers,), out)
        return out
    if cfg.family in ("dense", "moe", "vlm"):
        for name in ("unembed", "vision_proj"):
            if name in tree:
                out[name] = _tensor(tree[name])
        period = cfg.local_global_period
        if not period:
            _stacked(tree["blocks"], "blocks", (cfg.n_layers,), out)
            return out
        n_groups, n_tail = divmod(cfg.n_layers, period)
        _stacked(tree["blocks"], "blocks", (n_groups, period), out)
        if n_tail:
            _stacked(tree["tail"], "tail", (n_tail,), out)
        return out
    n_groups, n_tail = divmod(cfg.n_layers, cfg.hybrid_attn_every)
    _stacked(tree["groups"], "groups", (n_groups, cfg.hybrid_attn_every),
             out)
    if n_tail:
        _stacked(tree["tail"], "tail", (n_tail,), out)
    _flatten(tree["shared_attn"], "shared_attn", out)
    return out

