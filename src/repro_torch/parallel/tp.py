"""Ambient tensor-parallel context of the serving steps (mirror of
``repro.parallel.tp``).

The JAX servers run a whole serve / prefill step under one
``shard_map`` over the mesh's "model" axis. The port runs the same step
in every rank of a ``torch.distributed`` process group instead: each
rank holds its shard of the parameters and caches (``launch.serve``'s
``TpSpec``) and calls the same model functions, which read this
thread-local context to (a) reduce their row-parallel partials over the
group and (b) know which vocab rows and experts the local shard owns.

Every helper is an identity when no context is installed, so the model
code stays single-source: the same ``mlp()`` / ``attention()`` body runs
unsharded and under tensor parallelism. The context is installed even
for a group of one rank (a ``(1, 1)`` host mesh): the collective is
still issued (on the card, a captured decode step holds an NCCL
all-reduce), and a sum over one rank is an exact identity, which keeps
the host-mesh servers bit-exact against the solo server.

The transport follows the group (``TpContext.transport``): ``"nccl"``
for a group on CUDA devices, ``"gloo"`` for CPU tensors, and
``"gloo-host-staged"`` for a gloo group whose tensors live on a card
(two ranks sharing one card: NCCL refuses two ranks on one device).
Gloo lacks an all-gather of CUDA tensors, so there every helper copies
its tensor to the host, runs the collective and copies the result back,
on one route for both collectives. A CUDA graph cannot hold those
copies: a capture that reaches one raises (run under
``graphs.disable_capture()``).

Each helper adds the bytes it moves to ``coll_bytes`` by kind
("all-reduce", "all-gather") with the JAX package's accounting
(``launch.roofline``): the result's bytes times ``ALGO_FACTOR`` of the
kind. A group of one rank moves nothing and counts nothing, as a size-1
collective vanishes from the reference's compiled program. A captured
graph re-adds the bytes its capture counted at every replay
(``launch.graphs``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.launch.roofline import ALGO_FACTOR

_STATE = threading.local()

TRANSPORTS = ("nccl", "gloo", "gloo-host-staged")

# collective kind -> bytes moved so far (result bytes x ALGO_FACTOR)
coll_bytes: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True, eq=False)
class TpContext:
    axis: str        # mesh axis the step is sharded over ("model")
    size: int        # ranks on that axis
    rank: int        # this rank's index on it
    group: Any       # the axis' torch.distributed process group
    transport: str   # one of TRANSPORTS


def active() -> TpContext | None:
    """The installed TP context, or None outside tensor-parallel
    serving."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def tensor_parallel(ctx: TpContext):
    """Install ``ctx`` while a step runs."""
    if ctx.transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                         f"{ctx.transport!r}")
    prev = active()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def collective_bytes() -> dict[str, float]:
    """Bytes counted per kind since the last ``reset_coll_bytes``."""
    return {k: float(coll_bytes[k]) for k in ALGO_FACTOR}


def reset_coll_bytes() -> None:
    coll_bytes.clear()


def _count(ctx: TpContext, kind: str, result: torch.Tensor) -> None:
    if ctx.size > 1:
        coll_bytes[kind] += (result.numel() * result.element_size()
                             * ALGO_FACTOR[kind])


def _staged(ctx: TpContext, x: torch.Tensor) -> bool:
    """Whether this collective goes through host memory (gloo with a
    tensor on the card); raises inside a CUDA graph capture."""
    if ctx.transport != "gloo-host-staged":
        return False
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a gloo group stages its collectives through host memory, "
            "which a CUDA graph cannot hold: run the servers of this "
            "mesh under graphs.disable_capture()")
    return x.is_cuda


def psum_partial(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel partial over the model axis (identity when no
    TP context is active). Reduces ``x`` in place when it is contiguous:
    every caller passes a fresh partial."""
    ctx = active()
    if ctx is None:
        return x
    x = x.contiguous()
    if _staged(ctx, x):
        host = x.cpu()
        dist.all_reduce(host, group=ctx.group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=ctx.group)
    _count(ctx, "all-reduce", x)
    return x


def all_gather_cols(x: torch.Tensor) -> torch.Tensor:
    """Gather column-parallel shards along the LAST dim (tiled), so each
    rank leaves with the full-width tensor. Identity outside TP."""
    ctx = active()
    if ctx is None:
        return x
    x = x.contiguous()
    if ctx.transport == "nccl":
        out = torch.empty((ctx.size, *x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=ctx.group)
        parts = out.unbind(0)
    else:
        staged = _staged(ctx, x)
        src = x.cpu() if staged else x
        parts = [torch.empty_like(src) for _ in range(ctx.size)]
        dist.all_gather(parts, src, group=ctx.group)
        if staged:
            parts = [p.to(x.device) for p in parts]
    out = torch.cat(parts, dim=-1)
    _count(ctx, "all-gather", out)
    return out


def shard_offset(n_local: int) -> int:
    """Global offset of this shard's slice given its local extent (vocab
    rows, expert ids, ...). 0 outside TP."""
    ctx = active()
    if ctx is None:
        return 0
    return ctx.rank * int(n_local)


def model_only_pspec(pspec) -> tuple:
    """Project a sharding description (a tuple of per-dim entries: an
    axis name, a tuple of names, or None) onto the model axis only.

    Serving TP shards exactly one thing, the head / latent ("model")
    axis; batch and FSDP entries are dropped. Tuple entries like
    ``("pod", "data")`` reduce to their "model" member or None; trailing
    Nones are trimmed, as ``PartitionSpec`` prints them."""
    entries = []
    for e in tuple(pspec):
        if e == "model" or (isinstance(e, (tuple, list)) and "model" in e):
            entries.append("model")
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def model_dim(pspec) -> int | None:
    """The dim a description shards over "model", or None."""
    entries = model_only_pspec(pspec)
    return entries.index("model") if "model" in entries else None
