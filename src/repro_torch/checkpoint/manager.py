"""Checkpointing substrate: atomic, async, retained (port of
``repro.checkpoint.manager``).

  * **Atomic**: checkpoints are written to ``<dir>/tmp.<step>`` and
    ``os.replace``d into place — a crash mid-save never corrupts the
    latest valid checkpoint; a directory without its manifest does not
    count.
  * **Manifest**: every checkpoint carries its step, caller metadata
    (config hash, arch, cell) and the leaves' key paths; ``restore``
    checks the metadata and every leaf's shape.
  * **Async**: ``save_async`` copies the tree to host memory at once
    and writes it in a background thread; ``wait()`` joins before the
    next save or exit.
  * **Retention**: keeps the newest ``keep`` checkpoints.

Leaves are tensors of a tree of dicts, lists and tuples
(``repro_torch.tree``), stored per leaf in one ``arrays.npz`` under
their key paths; bf16 goes to disk as fp32 (a lossless container) and
comes back in the type of the tree it is restored into. One device: the
JAX manager's re-sharding onto another mesh is not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _flatten(state) -> dict[str, np.ndarray]:
    """Host copies of every leaf, keyed by path."""
    flat = {}
    for key, leaf in tree.leaves_with_path(state):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat[key] = t.cpu().numpy().copy()
    return flat


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, meta: dict | None = None) -> str:
        self.wait()
        return self._write(step, _flatten(state), meta or {})

    def save_async(self, step: int, state, *,
                   meta: dict | None = None) -> None:
        self.wait()
        flat = _flatten(state)  # host snapshot NOW (device -> host copy)
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, meta or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, meta: dict) -> str:
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "keys": sorted(flat), "meta": meta}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            # only completed (atomically renamed) checkpoints count
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, *, expect_meta: dict | None = None):
        """Restore into the structure of ``like`` (a tree of tensors):
        each leaf in ``like``'s type, on its device. Raises on a metadata
        mismatch, a missing key or a shape mismatch."""
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        for k, v in (expect_meta or {}).items():
            got = manifest["meta"].get(k)
            if got != v:
                raise ValueError(f"checkpoint meta mismatch for {k!r}: "
                                 f"saved {got!r}, expected {v!r}")
        data = np.load(os.path.join(path, "arrays.npz"))
        leaves = []
        for key, leaf in tree.leaves_with_path(like):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key!r}: saved "
                                 f"{arr.shape}, model wants "
                                 f"{tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype))
        return tree.unflatten(like, leaves), manifest
