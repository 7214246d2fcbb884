"""Seed coercion shared by every stochastic entry point.

A copy of ``repro.core.seeding`` (numpy only). Seeds flow out of configs
and RNGs as python ints, numpy integer scalars and 0-d arrays
(``np.array(7)``), which ``np.isscalar`` wrongly rejects, and a negative
seed (legal arithmetic on a user seed, e.g. ``seed - 7919``) makes
``np.random.default_rng`` raise. These helpers are the one front door:
coerce any int-like scalar, and map it onto the non-negative entropy
word ``np.random.SeedSequence`` demands.
"""
from __future__ import annotations

import numpy as np

__all__ = ["coerce_seed", "rng_entropy"]

#: SeedSequence entropy words are unsigned; fold signed seeds into the
#: 64-bit ring so every int-like scalar is a legal, deterministic seed.
_ENTROPY_MASK = 0xFFFF_FFFF_FFFF_FFFF


def coerce_seed(seed, name: str = "seed") -> int:
    """A plain python int from any int-like scalar.

    Accepts python ints, numpy integer scalars, and 0-d integer arrays;
    rejects floats (silent truncation would de-correlate reruns) and
    anything non-scalar. Mirrors the scalar arm of the fleet solver's
    seed normalization so every sampler fails the same way.
    """
    arr = np.asarray(seed)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"{name} must be int-like, got dtype {arr.dtype}")
    if arr.ndim != 0:
        raise ValueError(
            f"{name} must be a scalar, got shape {arr.shape}")
    return int(arr)


def rng_entropy(seed, name: str = "seed") -> int:
    """A non-negative entropy word for ``np.random.default_rng``.

    Non-negative seeds pass through unchanged (existing golden draws are
    preserved); negative seeds map two's-complement style onto the upper
    half of the 64-bit ring, so distinct negatives stay distinct and
    deterministic instead of raising.
    """
    return coerce_seed(seed, name) & _ENTROPY_MASK
