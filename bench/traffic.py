"""The one traffic generator: a mix is a JSON file of parameters under
``bench/traffic/``, read by ``load`` and turned into request batches by
``Traffic.batch``.

A mix serves rectangular batches in a closed loop: one client sends a batch of
``batch`` prompts of ``prompt_len`` tokens, waits for its ``new_tokens``
greedy tokens, and sends the next. Token ids are drawn uniformly from
``[first_id, vocab)``; batch ``k`` of a run depends only on the seed and ``k``,
so every seed sends the same sizes. The output check draws ``check_calls``
of the window's calls and compares ``check_rows`` rows of each, drawn with
the batch.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["Traffic", "load"]

KEYS = {"loop", "clients", "batch", "prompt_len", "new_tokens", "first_id",
        "check_calls", "check_rows"}


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    batch: int
    prompt_len: int
    new_tokens: int
    first_id: int
    check_calls: int
    check_rows: int

    def batch_at(self, seed: int, k: int, vocab: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch ``k``'s prompts (batch, prompt_len) int32 and the rows whose
        logits the run records for the output check, in order."""
        rng = np.random.default_rng([seed, k])
        tokens = rng.integers(self.first_id, vocab,
                              (self.batch, self.prompt_len), dtype=np.int32)
        rows = rng.choice(self.batch, self.check_rows, replace=False)
        return tokens, np.sort(rows)

    @property
    def tokens_per_call(self) -> int:
        """Prompt tokens prefilled plus tokens generated, over the batch."""
        return self.batch * (self.prompt_len + self.new_tokens)


def load(path: Path) -> Traffic:
    """The mix in ``path``; refuses keys it does not know and loops it does
    not serve."""
    raw = json.loads(Path(path).read_text())
    unknown = set(raw) - KEYS - {"why"}
    if unknown:
        raise ValueError(f"{path}: unknown keys {sorted(unknown)}")
    if raw["loop"] != "closed" or raw["clients"] != 1:
        raise ValueError(f"{path}: only a closed loop of one client is "
                         f"generated")
    return Traffic(name=Path(path).stem, batch=raw["batch"],
                   prompt_len=raw["prompt_len"],
                   new_tokens=raw["new_tokens"], first_id=raw["first_id"],
                   check_calls=raw["check_calls"],
                   check_rows=raw["check_rows"])
