"""Serving meshes over ``torch.distributed`` (mirror of
``repro.launch.mesh``).

A JAX mesh is an array of devices with axis names; its sharded programs
run as one SPMD program over it. The port runs one process per mesh
position instead (a rank of a ``torch.distributed`` world): a ``Mesh``
records the mesh's shape and canonical axis names, this rank's device,
and the process group of the rank's "model" row, over which the
serving steps reduce their partials (``parallel.tp``). Ranks are laid
out row-major: rank r sits at column ``r % C`` of row ``r // C``, so
the "model" group of row i is ranks ``[i * C, (i + 1) * C)``; the other
axes replicate (each row serves the same requests).

Axes, as in the JAX package:
  * rank 2: ("data", "model")
  * rank 3: ("pod", "data", "model")

``mesh_info`` asserts them, so a mesh with drifting names (or an object
that is no mesh) fails at construction.

The group's backend follows the device: NCCL for a mesh on CUDA
devices, gloo on the CPU. ``backend="gloo"`` with a CUDA device is the
two-ranks-on-one-card case (NCCL puts no two ranks on one GPU); its
collectives are staged through the host (``parallel.tp``). An NCCL
group runs one collective when it is made, so its communicator exists
before any CUDA graph captures a collective.

``torch.distributed.device_mesh.init_device_mesh`` is not used: it binds
rank r to device ``r % device_count`` with the device's default backend,
which cannot express two gloo ranks on one card. The JAX package's
``make_production_mesh`` (the 256- and 512-chip dry-run meshes) is not
ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models.layers import MeshInfo
from repro_torch.parallel.tp import TpContext

# the one canonical axis-name vocabulary, by mesh rank
CANONICAL_AXES = {
    2: ("data", "model"),
    3: ("pod", "data", "model"),
}

# process-group timeout of the worlds and groups made here
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)

# (backend, ranks) -> process group, made once a process
_GROUPS: dict[tuple, Any] = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a serving mesh."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device
    group: Any          # the "model" row's process group
    rank: int           # this rank's column (its index on "model")
    backend: str        # the group's backend: "nccl" or "gloo"

    @property
    def devices(self) -> np.ndarray:
        """Global ranks laid out in the mesh's shape (``mesh.devices``
        of a JAX mesh)."""
        return np.arange(int(np.prod(self.shape))).reshape(self.shape)

    @property
    def transport(self) -> str:
        """How the helpers of ``parallel.tp`` move data on this mesh."""
        if self.backend == "nccl":
            return "nccl"
        return "gloo-host-staged" if self.device.type == "cuda" else "gloo"

    def tp_context(self) -> TpContext:
        return TpContext(axis="model", size=self.shape[-1], rank=self.rank,
                         group=self.group, transport=self.transport)


def mesh_info(mesh) -> MeshInfo:
    names = tuple(getattr(mesh, "axis_names", ()))
    expected = CANONICAL_AXES.get(len(names))
    if names != expected:
        raise ValueError(
            f"mesh axes {names} diverge from the canonical "
            f"{expected or 'serving axis sets ' + str(tuple(CANONICAL_AXES.values()))}"
            " — every sharded program in launch/ keys its specs off these"
            " names")
    return MeshInfo.from_axes(names, dict(zip(names, mesh.shape)))


def _backend(device: torch.device, backend: str | None) -> str:
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group needs a CUDA device")
    return backend


def _group(ranks: list[int], backend: str, *, local: bool = False):
    """The process group of ``ranks`` on ``backend``, made once. Every
    rank of the world calls this for every group in the same order,
    unless ``local`` (only the members call it)."""
    key = (backend, tuple(ranks))
    g = _GROUPS.get(key)
    if g is None:
        g = _GROUPS[key] = dist.new_group(
            ranks, backend=backend, timeout=DEFAULT_TIMEOUT,
            use_local_synchronization=local)
    return g


def _warm(group, device: torch.device, backend: str) -> None:
    """One eager collective on a new NCCL group: its communicator is made
    at its first collective, which a CUDA graph capture forbids."""
    if backend == "nccl":
        torch.cuda.set_device(device)
        t = torch.zeros(1, device=device)
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize(device)


def _cuda_device(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _world_of_one(backend: str) -> None:
    """A one-rank default group from a ``FileStore`` in a temporary
    directory, for a plain process with no launcher."""
    path = os.path.join(tempfile.mkdtemp(prefix="repro-mesh-"), "store")
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo",
        store=dist.FileStore(path, 1), rank=0, world_size=1,
        timeout=DEFAULT_TIMEOUT)


def make_host_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """A single-device mesh with the production axis names (all size
    1): the sharded step functions, their collectives over a group of
    this rank alone, on one device (``cuda`` unless the caller asks for
    another). Works in a plain process: where no process group exists
    it makes a one-rank world. ``multi_pod`` gives the 3-axis name set."""
    dev = _cuda_device(resolve_device(device))
    backend = _backend(dev, None)
    if not dist.is_initialized():
        _world_of_one(backend)
    rank = dist.get_rank()
    group = _group([rank], backend, local=True)
    _warm(group, dev, backend)
    shape = (1, 1, 1) if multi_pod else (1, 1)
    return Mesh(shape=shape, axis_names=CANONICAL_AXES[len(shape)],
                device=dev, group=group, rank=0, backend=backend)


def make_serving_mesh(shape: tuple[int, ...], *, device=None,
                      backend: str | None = None) -> Mesh:
    """A serving mesh of ``shape`` over the ranks of the current world,
    with the canonical axis names for its rank — ``(1, 2)`` is data=1 x
    model=2 tensor parallel. The world must hold exactly
    ``prod(shape)`` ranks, started by the caller (``python -m
    torch.distributed.run`` or ``init_process_group``); every rank calls
    this. ``device`` defaults to ``cuda:LOCAL_RANK`` (or the rank modulo
    the card count); ``backend`` to NCCL on a card, gloo on the CPU."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in CANONICAL_AXES:
        raise ValueError(f"serving mesh must be rank 2 or 3, got {shape}")
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise ValueError(
            f"serving mesh {shape} needs a world of {n} ranks and this "
            "process has no process group: start one process a rank "
            "(python -m torch.distributed.run --nproc-per-node "
            f"{n} ...) or call torch.distributed.init_process_group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"serving mesh {shape} needs a world of {n} "
                         f"ranks, this one has {world}")
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    dev = _cuda_device(resolve_device(device))
    backend = _backend(dev, backend)
    cols = shape[-1]
    group = None
    for row in range(n // cols):
        g = _group(list(range(row * cols, (row + 1) * cols)), backend)
        if row == rank // cols:
            group = g
    _warm(group, dev, backend)
    return Mesh(shape=shape, axis_names=CANONICAL_AXES[len(shape)],
                device=dev, group=group, rank=rank % cols, backend=backend)


def destroy() -> None:
    """Tear down the groups made here and the default process group
    (the end of a run: NCCL's threads stop with their groups)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def num_chips(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= s
    return n
