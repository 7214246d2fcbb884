"""Async, atomic, keep-N checkpointing: the port of
``repro/checkpoint/manager.py``, with its on-disk layout.

Layout::

    <dir>/step_00000042/             one dir per step
        manifest.json                tree structure + shapes/dtypes
        000000.npy, 000001.npy, ...  one file per leaf (flattened order)
    <dir>/LATEST                     text file: last durably-written step

A tree is nested dicts (flattened in sorted-key order, as the reference's
``jax.tree.flatten``), lists, tuples and named tuples of tensors, numpy
arrays or scalars; the trainer's leaves come from ``state_dict()`` and the
optimiser state. A bfloat16 leaf, which numpy cannot hold, is written as
its 16-bit words (a ``uint16`` ``.npy``) and listed as ``"bfloat16"`` in
the manifest, so it comes back bit for bit.

Durability: leaves are written into ``step_XXXXXXXX.tmp``, which is
renamed to ``step_XXXXXXXX``; only then is LATEST replaced (write to a
temporary file + rename). A crash mid-save leaves a ``.tmp`` directory that
``restore`` ignores and the next save of that step overwrites.

Async: ``save()`` copies every leaf to host memory before it returns (the
trainer updates its parameters in place in the next step), then writes the
files on a background thread; ``wait()`` joins it, and every ``save``
waits for the one before. ``restore`` returns the tree with CPU tensors
(numpy arrays and scalars come back as tensors too); the caller copies them
onto its device. The trainer on a device mesh saves whole tensors (every
rank gathers, rank 0 writes) and cuts each rank's slices on restore, so a
checkpoint is the same on any mesh (``launch.train``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- helpers
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                txt = f.read().strip()
            if txt and os.path.isdir(self._step_dir(int(txt))):
                return int(txt)
        steps = self.steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        leaves: List[Any] = []
        structure = _flatten(tree, leaves)
        # snapshot to host NOW: the caller updates its tensors in place next
        host = [_to_host(leaf) for leaf in leaves]
        manifest = {
            "treedef": structure,
            "leaves": [{"shape": list(a.shape), "dtype": dtype}
                       for a, dtype in host],
            "step": step,
        }

        def write():
            tmp = self._step_dir(step) + ".tmp"
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (a, _) in enumerate(host):
                np.save(os.path.join(tmp, f"{i:06d}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.rename(os.path.join(self.dir, "LATEST.tmp"),
                      os.path.join(self.dir, "LATEST"))
            self._prune()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None) -> Any:
        """The tree saved at ``step`` (the latest by default), its leaves
        as CPU tensors."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = [_from_host(np.load(os.path.join(d, f"{i:06d}.npy")),
                             meta["dtype"])
                  for i, meta in enumerate(manifest["leaves"])]
        return _unflatten(manifest["treedef"], iter(leaves))


def _to_host(leaf: Any):
    """(host numpy copy, dtype name) of a leaf; bfloat16 as its 16-bit
    words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# JSON-able tree structure (dicts / lists / tuples / named tuples / leaves),
# the reference's format
# ---------------------------------------------------------------------------

def _flatten(tree: Any, leaves: List[Any]) -> Any:
    """The tree's JSON structure; its leaves appended to ``leaves`` in
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _flatten(tree[k], leaves)
                          for k in sorted(tree)}}
    if hasattr(tree, "_fields"):          # named tuple
        return {"__kind__": "namedtuple", "name": type(tree).__name__,
                "items": {f: _flatten(getattr(tree, f), leaves)
                          for f in tree._fields}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_flatten(v, leaves) for v in tree]}
    leaves.append(tree)
    return {"__kind__": "leaf"}


def _unflatten(spec: Any, leaves) -> Any:
    kind = spec["__kind__"]
    if kind in ("dict", "namedtuple"):
        # named tuples come back as dicts keyed by field, as in the
        # reference; callers rebuild the type (OptState(**d))
        return {key: _unflatten(v, leaves)
                for key, v in spec["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_unflatten(v, leaves) for v in spec["items"]]
        return seq if kind == "list" else tuple(seq)
    return next(leaves)
