"""Plan cache for the always-on planning service (DESIGN.md §11), ported
from ``repro.core.plancache`` (numpy and threading only; the gate
replays through the port's ``simulate_np``). Keys are byte-equal to the
reference's for the same DAG, environment and load scale.

At service scale most rounds re-solve scenarios the fleet has already
seen — the same DNNs under a bandwidth/price snapshot and load level
that recur as conditions oscillate. The cache amortizes the PSO-GA
solve away for those rounds: entries are keyed by

    (DNN identity, env bucket, load bucket)

where the DNN identity is a content fingerprint of the layer DAG and
the env/load buckets quantize the environment matrices and the offered
load onto a log grid (two snapshots within the quantization step share
a key). Quantization is only a cheap pre-filter, never a correctness
argument: every hit passes a **replay-exact revalidation gate** before
it is served —

  1. ``plan_is_valid(prob, plan)`` — the stale-plan guard's static
     gate (shape, ranges, pins, live links) against the LIVE env;
  2. replaying the stored plan through ``simulate_np`` under the live
     env must reproduce the total cost and makespan recorded at store
     time bit-for-bit.

A snapshot that drifted inside the bucket (or a fingerprint collision)
changes the replayed cost, fails gate 2, and the entry is dropped and
counted as a miss — so a served hit is exactly the plan a fresh
warm-started solve would keep, and cache-on rounds stay bit-identical
to cache-off rounds. Eviction is plain LRU under a capacity bound; all
operations are thread-safe so N concurrent services can share one
cache (DESIGN.md §11 phase 2).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np

from .dag import LayerDAG
from .environment import Environment
from .online import plan_is_valid
from .simulator import SimProblem, simulate_np

__all__ = ["PlanCache", "PlanCacheConfig", "dag_fingerprint"]

#: quantization sentinels for non-positive / infinite matrix entries
#: (a severed link — bandwidth 0 — must land in its own bucket).
_NEG_BUCKET = -(2 ** 62)
_INF_BUCKET = 2 ** 62


@dataclasses.dataclass(frozen=True)
class PlanCacheConfig:
    """Knobs for :class:`PlanCache`.

    capacity:   max entries before LRU eviction.
    env_quant:  log-grid step for environment matrices — 0.05 buckets
                values at ~5% relative resolution.
    load_quant: log-grid step for the offered-load scale.
    """

    capacity: int = 64
    env_quant: float = 0.05
    load_quant: float = 0.1

    def __post_init__(self) -> None:
        if int(self.capacity) < 1:
            raise ValueError(
                f"capacity must be >= 1, got {self.capacity!r}")
        for name in ("env_quant", "load_quant"):
            v = getattr(self, name)
            if not np.isfinite(v) or v <= 0.0:
                raise ValueError(f"{name} must be positive finite, "
                                 f"got {v!r}")


def dag_fingerprint(dag: LayerDAG) -> bytes:
    """Content fingerprint of a layer DAG — the "DNN identity" part of
    the cache key. Two structurally identical DAGs (same layers, edges,
    datasets, pins, deadlines) share a fingerprint; names don't count.
    """
    h = hashlib.blake2b(digest_size=16)
    for a in (dag.compute, dag.edges, dag.edge_mb, dag.app_id,
              dag.deadline, dag.pinned):
        arr = np.ascontiguousarray(a)
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.digest()


def _quantize(a: np.ndarray, q: float) -> np.ndarray:
    """Log-bucket a non-negative array at relative resolution ~q.

    0 (severed link / free resource) and +inf (self-link bandwidth) get
    their own sentinel buckets so topology changes always change the
    key. NaN is rejected — the service validates env snapshots before
    the cache ever sees them.
    """
    a = np.asarray(a, np.float64)
    if np.any(np.isnan(a)):
        raise ValueError("cannot bucket a NaN environment snapshot")
    out = np.full(a.shape, _NEG_BUCKET, np.int64)
    pos = np.isfinite(a) & (a > 0.0)
    out[pos] = np.round(np.log(a[pos]) / q).astype(np.int64)
    out[np.isposinf(a)] = _INF_BUCKET
    return out


class _Entry(NamedTuple):
    plan: np.ndarray
    total_cost: float
    makespan: float


class PlanCache:
    """LRU plan cache with a replay-exact revalidation gate.

    Counters (``stats()``): ``hits`` / ``misses`` are per-problem
    lookup outcomes; ``revalidation_failures`` counts entries dropped
    by the gate (each also counts as a miss); ``stores`` / ``evictions``
    / ``store_rejects`` track the write side.

    With a ``telemetry`` channel every increment is mirrored live onto
    the registry as ``plancache.<name>`` counters (DESIGN.md §13), so
    exported snapshots agree with ``stats()`` at any instant. Telemetry
    only observes — lookup/store outcomes are identical without it.
    """

    def __init__(self, cfg: Optional[PlanCacheConfig] = None, *,
                 telemetry=None) -> None:
        self.cfg = cfg if cfg is not None else PlanCacheConfig()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self._tel = telemetry
        self._stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "revalidation_failures": 0,
            "stores": 0, "evictions": 0, "store_rejects": 0}

    def _bump(self, name: str, n: int = 1) -> None:
        """Count under ``self._lock``; the registry lock is a leaf, so
        mirroring inside ours cannot deadlock."""
        self._stats[name] += n
        if self._tel is not None and n:
            self._tel.inc(f"plancache.{name}", n)

    # -- keys ----------------------------------------------------------
    def key(self, dag: Union[LayerDAG, bytes], env: Environment,
            load_scale: float = 1.0) -> tuple:
        """Cache key for (DNN identity, env bucket, load bucket)."""
        fp = dag_fingerprint(dag) if isinstance(dag, LayerDAG) else dag
        q = self.cfg.env_quant
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(env.tier).tobytes())
        for a in (env.power, env.cost_per_sec, env.bandwidth,
                  env.tran_cost):
            h.update(_quantize(a, q).tobytes())
        if not np.isfinite(load_scale) or load_scale <= 0.0:
            raise ValueError(f"load_scale must be positive finite, "
                             f"got {load_scale!r}")
        load_bucket = int(np.round(np.log(load_scale)
                                   / self.cfg.load_quant))
        return (fp, h.digest(), load_bucket)

    # -- read side -----------------------------------------------------
    def _validate(self, entry: _Entry, prob: SimProblem) -> bool:
        """The replay-exact gate: static validity + bit-identical
        replayed cost/makespan under the live env."""
        if not plan_is_valid(prob, entry.plan):
            return False
        res = simulate_np(prob, entry.plan)
        return (float(res.total_cost) == entry.total_cost
                and float(res.makespan) == entry.makespan)

    def lookup(self, key: tuple, prob: SimProblem
               ) -> Optional[np.ndarray]:
        """The stored plan for ``key`` iff it survives the gate under
        ``prob``'s live env; a failed gate drops the entry."""
        got = self.lookup_fleet([key], [prob])
        return None if got is None else got[0]

    def lookup_fleet(self, keys: Sequence[tuple],
                     probs: Sequence[SimProblem]
                     ) -> Optional[List[np.ndarray]]:
        """All-or-nothing fleet lookup: every problem must hit (and
        survive the gate) or the whole round is a miss — a partial hit
        still needs the fleet solve, so serving it would only fork the
        cache-on/off trajectories. Revalidation failures drop their
        entries either way.
        """
        if len(keys) != len(probs):
            raise ValueError(f"{len(keys)} keys for {len(probs)} "
                             f"problems")
        with self._lock:
            entries = [self._entries.get(k) for k in keys]
        plans: List[Optional[np.ndarray]] = []
        failed: List[tuple] = []
        for key, entry, prob in zip(keys, entries, probs):
            if entry is None:
                plans.append(None)
            elif self._validate(entry, prob):
                plans.append(entry.plan)
            else:
                plans.append(None)
                failed.append(key)
        with self._lock:
            for key in failed:
                self._entries.pop(key, None)
                self._bump("revalidation_failures")
            if all(p is not None for p in plans):
                self._bump("hits", len(keys))
                for key in keys:
                    if key in self._entries:
                        self._entries.move_to_end(key)
                return [np.array(p) for p in plans]
            self._bump("misses", len(keys))
            return None

    # -- write side ----------------------------------------------------
    def store(self, key: tuple, prob: SimProblem, plan) -> bool:
        """Record a solver-produced plan with its replay invariants;
        rejects plans that fail the static gate or replay non-finite."""
        if not plan_is_valid(prob, plan):
            with self._lock:
                self._bump("store_rejects")
            return False
        res = simulate_np(prob, plan)
        total, make = float(res.total_cost), float(res.makespan)
        if not (np.isfinite(total) and np.isfinite(make)):
            with self._lock:
                self._bump("store_rejects")
            return False
        entry = _Entry(np.array(plan), total, make)
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.cfg.capacity:
                self._entries.popitem(last=False)
                self._bump("evictions")
            self._bump("stores")
        return True

    # -- bookkeeping ---------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[tuple]:
        """Current keys, LRU-oldest first."""
        with self._lock:
            return list(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def hit_rate(self) -> float:
        """hits / (hits + misses), 0.0 before any lookup."""
        with self._lock:
            n = self._stats["hits"] + self._stats["misses"]
            return self._stats["hits"] / n if n else 0.0

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
