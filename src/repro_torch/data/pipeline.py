"""Deterministic, restartable data pipeline: a copy of
``repro/data/pipeline.py`` (numpy only), so ``batch(i)`` is bit for bit
the reference's for the same config, shape, seed and ``i``.

Design requirements at scale:
  * **Stateless indexing** — batch ``i`` is a pure function of
    ``(seed, i)`` (counter-based Philox), so a job restarted from a step-k
    checkpoint resumes the stream exactly at batch k with no iterator
    state to persist. This is the data-side half of fault tolerance.
  * **Per-host sharding** — ``host_slice`` and ``make_stream(
    process_index=, process_count=)`` are the reference's, kept bit for
    bit, quirk included: ``batch(i)`` seeds Philox with ``i`` alone and
    draws ``global_batch / process_count`` rows, so every process gets the
    same rows (the first rows of the single-process batch), not its slice
    of the global batch. The trainer on a mesh (``launch.train``) does not
    use it: every rank draws the global batch and keeps its data shard's
    rows, which is what the reference's single controller feeds its
    jitted step.
  * **Modality-aware** — LM families get packed token streams; encdec
    gets (audio_embeds, tokens); vlm gets (vision, tokens) — matching
    ``models.model_zoo.input_specs`` exactly.

Two sources: ``synthetic`` (Zipf-ish token draws, always available) and
``bytes`` (any UTF-8 file packed as byte-level tokens + shift).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeSpec

__all__ = ["DataConfig", "SyntheticStream", "byte_tokenize", "host_slice",
           "make_stream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    source: str = "synthetic"        # synthetic | bytes
    path: Optional[str] = None       # for source="bytes"
    zipf_a: float = 1.2              # synthetic token skew


def host_slice(global_batch: int, process_index: int = 0,
               process_count: int = 1) -> slice:
    """The batch rows this host materializes."""
    if global_batch % process_count:
        raise ValueError("global_batch must divide process_count")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def byte_tokenize(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), np.uint8).astype(np.int32)


class SyntheticStream:
    """Infinite stream of training batches; ``batch(i)`` is pure in (seed, i)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data: DataConfig = DataConfig(),
                 process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.shape = shape
        self.data = data
        self.sl = host_slice(shape.global_batch, process_index,
                             process_count)
        self.corpus = None
        if data.source == "bytes":
            if not data.path:
                raise ValueError("source='bytes' needs a path")
            self.corpus = byte_tokenize(data.path)
            if self.corpus.size < shape.seq_len + 2:
                raise ValueError("corpus smaller than one sequence")

    # -- pure batch constructor --------------------------------------------
    def batch(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.data.seed, counter=[0, 0, 0, i]))
        cfg, shape = self.cfg, self.shape
        b = self.sl.stop - self.sl.start
        s = shape.seq_len
        if self.corpus is not None:
            starts = rng.integers(0, self.corpus.size - s - 1, size=b)
            toks = np.stack([self.corpus[st:st + s + 1] for st in starts])
        else:
            # Zipf draws clipped to the vocab: cheap, heavy-tailed, and
            # deterministic — loss curves behave like natural text enough
            # for throughput/convergence smoke purposes.
            toks = rng.zipf(self.data.zipf_a, size=(b, s + 1))
            toks = np.minimum(toks - 1, cfg.vocab - 1).astype(np.int32)
        toks = toks.astype(np.int32)
        if cfg.family == "encdec":
            frames = rng.standard_normal((b, s, cfg.d_model)).astype(
                np.float32)
            return {"audio_embeds": frames,
                    "tokens": toks[:, : s // 8 + 1]}
        if cfg.family == "vlm":
            tv = min(cfg.vision_tokens, max(s // 4, 8))
            vis = rng.standard_normal((b, tv, cfg.d_model)).astype(
                np.float32)
            return {"vision": vis, "tokens": toks[:, : s - tv + 1]}
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1

    def at(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Resume iterator: yields batch(start_step), batch(start_step+1)…"""
        i = start_step
        while True:
            yield self.batch(i)
            i += 1


def make_stream(cfg: ModelConfig, shape: ShapeSpec,
                data: DataConfig = DataConfig(), **kw) -> SyntheticStream:
    return SyntheticStream(cfg, shape, data, **kw)
