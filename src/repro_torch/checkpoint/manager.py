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
comes back in the type of the tree it is restored into.

Under a mesh (``placement=``, an ``models.layers.Placement`` of the
state tree) every rank calls ``save`` / ``restore``: the state is
gathered whole (a collective) and written by rank 0 alone in the
one-device layout, as the JAX manager writes whole arrays; the other
ranks wait for it (``wait`` ends in a barrier). ``restore`` reads the
whole arrays and re-shards them onto the mesh, so a checkpoint written
on a (2, 2) mesh resumes on one device, and the reverse.
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
import torch.distributed as dist

from repro_torch import tree
from repro_torch.models.layers import shard_leaf


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
        self._mesh = None      # the mesh of the last save, for the barrier

    # -- save ---------------------------------------------------------------
    def _snapshot(self, state, placement) -> dict | None:
        """Host copies of the whole state, on the writing rank (None on
        the others)."""
        self._mesh = None if placement is None else placement.mesh
        if placement is not None:
            state = placement.gather(state)
            if placement.mesh.fsdp_rank or placement.mesh.rank:
                return None
        return _flatten(state)

    def save(self, step: int, state, *, meta: dict | None = None,
             placement=None) -> str:
        self.wait()
        flat = self._snapshot(state, placement)
        path = os.path.join(self.directory, f"step_{step:010d}")
        if flat is not None:
            path = self._write(step, flat, meta or {})
        self.wait()
        return path

    def save_async(self, step: int, state, *, meta: dict | None = None,
                   placement=None) -> None:
        self.wait()
        flat = self._snapshot(state, placement)  # host snapshot NOW
        if flat is not None:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta or {}),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; under a mesh every rank then waits for rank
        0's write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            self._mesh = None
            if dist.is_initialized() and dist.get_world_size() > 1:
                dist.barrier()

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

    def restore(self, step: int, like, *, expect_meta: dict | None = None,
                placement=None):
        """Restore into the structure of ``like`` (a tree of tensors):
        each leaf in ``like``'s type, on its device; under ``placement``
        ``like`` holds the rank's shards and each whole array is cut to
        its shard. Raises on a metadata mismatch, a missing key or a
        shape mismatch."""
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        for k, v in (expect_meta or {}).items():
            got = manifest["meta"].get(k)
            if got != v:
                raise ValueError(f"checkpoint meta mismatch for {k!r}: "
                                 f"saved {got!r}, expected {v!r}")
        data = np.load(os.path.join(path, "arrays.npz"))
        specs = (tree.leaf_specs(like, placement.specs)
                 if placement is not None
                 else [None] * len(tree.leaves(like)))
        leaves = []
        for (key, leaf), spec in zip(tree.leaves_with_path(like), specs):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            t = torch.from_numpy(arr)
            if spec is not None:
                t = shard_leaf(t, spec, placement.mesh)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key!r}: saved "
                                 f"{arr.shape}, model wants "
                                 f"{tuple(leaf.shape)}")
            leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return tree.unflatten(like, leaves), manifest
