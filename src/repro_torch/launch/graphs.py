"""Captured step programs: the port's counterpart of a jitted or scanned
program of the JAX package.

The JAX servers compile each decode segment (``serve.make_decode_scan``,
the schedulers' segment and admission programs) into one program keyed
by its executable-cache key. On the card the port records the same
work, a Python loop of eager steps, into a CUDA graph and replays it:

  * a ``Program`` wraps a step function ``fn(fixed, **inputs)``. On a
    CUDA device its first call runs ``fn`` eagerly (the warm-up: lazy
    ``nvcc`` builds and ``device_expr`` checks happen there, and its
    result is that call's result), then captures ``fn`` into a
    ``torch.cuda.CUDAGraph`` on static copies of ``inputs``; later calls
    ``copy_`` their inputs into those buffers and replay;
  * ``fixed`` (parameters, caches) is held by address: a graph is keyed
    by the identity of its fixed objects and the shapes of its inputs,
    so a server whose params object changes recaptures;
  * ``capture_after=N`` keeps a signature eager for its first N - 1
    calls and captures it at the N-th (the warm-up): a capture costs
    host time (entering it, running the step under it, instantiating
    the graph) that only replays pay back, so a program whose keys may
    recur only a few times captures the ones that do. ``capture_s``
    counts the host seconds spent capturing;
  * one graph memory pool is shared by a server's programs (``pool``):
    their outputs stay alive in the programs, and replays run in order
    on one stream, so intermediates may share memory;
  * kernel launch counts (``kops.launch_counts``), dispatch records
    (``kops.record_dispatches``) and the collective bytes of tensor-
    parallel steps (``parallel.tp.coll_bytes``) are counted in Python at
    call time, so a replay would count nothing: a graph keeps the counts,
    records and bytes its capture made, takes them back out of the
    ambient ones, and adds them again at each replay. A captured run
    counts exactly as an eager one. A step of a tensor-parallel server
    on NCCL captures its collectives with it (the mesh ran one eagerly,
    so the communicator exists before any capture).

``disable_capture()`` runs the same step functions eagerly (the
counterpart of ``jax.disable_jit``): tests and ``chip_smoke.py`` hold
captured against eager with it. Every step of every ported model keeps
its work on the card (the MoE layer's routing included,
``models/moe.py``), so every server captures on the card. A step that
read a tensor on the host would make its capture raise; nothing falls
back to eager.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
import warnings
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.parallel import tp as tplib

_STATE = threading.local()


@contextlib.contextmanager
def disable_capture():
    """Run every ``Program`` eagerly inside the block."""
    prev = capture_enabled()
    _STATE.enabled = False
    try:
        yield
    finally:
        _STATE.enabled = prev


def capture_enabled() -> bool:
    return getattr(_STATE, "enabled", True)


def captures(device: torch.device) -> bool:
    """Whether a server on ``device`` replays graphs: on the card, with
    capture enabled."""
    return device.type == "cuda" and capture_enabled()


def new_pool(device: torch.device):
    """A graph memory pool for one server's programs (None off the
    card)."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


def _signature(fixed, inputs: dict) -> tuple:
    shapes = tuple((path, None if t is None else (tuple(t.shape), t.dtype))
                   for path, t in tree.leaves_with_path(inputs))
    return (tuple(id(f) for f in fixed), shapes)


def _clone(inputs: dict) -> dict:
    return tree.map_leaves(
        lambda t: None if t is None else t.clone(), inputs)


def _copy_into(static: dict, inputs: dict) -> None:
    for dst, src in zip(tree.leaves(static), tree.leaves(inputs)):
        if dst is not None:
            dst.copy_(src)


@contextlib.contextmanager
def _capturing(graph, pool, device: torch.device):
    """Record the work of the block into ``graph`` on a side stream (the
    default stream cannot be captured), its memory from ``pool``.
    Python's cyclic collector is held off meanwhile: a graph of an
    unreachable server freed mid-capture would destroy its executable,
    which a capturing stream forbids. (``torch.cuda.graph`` would also
    empty the allocator's cache at every capture.)"""
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize(device)
        with torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(pool)
            try:
                yield
            except BaseException:
                # end the broken capture; the error that broke it is the
                # one to report
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                _end_generator_capture()
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()


def _end_generator_capture() -> None:
    """A capture that broke leaves the card's default generator in its
    capture state (``capture_end`` raised before restoring it), and every
    later draw from it raises. An empty capture on the capturing side
    stream runs the generator's capture prologue and epilogue, which
    restore it."""
    empty = torch.cuda.CUDAGraph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "the CUDA graph is empty"
        empty.capture_begin()
        empty.capture_end()


class _Graph:
    """One capture: static inputs, outputs, and the launch counts and
    dispatch records the capture made."""

    def __init__(self, fn: Callable, fixed: tuple, inputs: dict, pool,
                 device: torch.device) -> None:
        self.fixed = fixed                 # holds the addresses alive
        self.static = _clone(inputs)
        self.graph = torch.cuda.CUDAGraph()
        before = build.launches.copy()
        bytes_before = tplib.coll_bytes.copy()
        self.records: list = []
        try:
            with kops.record_dispatches(self.records):
                with _capturing(self.graph, pool, device):
                    self.out = fn(fixed, **self.static)
        finally:
            # the capture launched and moved nothing: its counts belong
            # to replays
            self.launches = build.launches - before
            build.launches.subtract(self.launches)
            self.coll_bytes = tplib.coll_bytes - bytes_before
            tplib.coll_bytes.subtract(self.coll_bytes)

    def replay(self, inputs: dict) -> Any:
        _copy_into(self.static, inputs)
        self.graph.replay()
        build.launches.update(self.launches)
        tplib.coll_bytes.update(self.coll_bytes)
        kops.extend_dispatches(self.records)
        return tree.map_leaves(lambda t: t.clone(), self.out)


class Program:
    """A step function run eagerly, or captured and replayed on the card
    (see the module docstring)."""

    def __init__(self, fn: Callable, *, device: torch.device,
                 pool=None, capture_after: int = 1) -> None:
        if capture_after < 1:
            raise ValueError(f"capture_after must be >= 1, got "
                             f"{capture_after}")
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.capture_after = capture_after
        self._graphs: dict[tuple, _Graph] = {}
        self._calls: collections.Counter = collections.Counter()
        self.captures = 0
        self.replays = 0
        self.eager_calls = 0
        self.capture_s = 0.0

    @property
    def captured(self) -> bool:
        """Whether a call here replays a graph."""
        return captures(self.device)

    def __call__(self, fixed: tuple, **inputs) -> Any:
        if not self.captured:
            self.eager_calls += 1
            return self.fn(fixed, **inputs)
        sig = _signature(fixed, inputs)
        graph = self._graphs.get(sig)
        if graph is not None:
            self.replays += 1
            return graph.replay(inputs)
        # eager below the threshold; at it, the warm-up, then the capture
        self.eager_calls += 1
        self._calls[sig] += 1
        out = self.fn(fixed, **inputs)
        if self._calls[sig] < self.capture_after:
            return out
        if any(g.fixed[0] is not fixed[0] for g in self._graphs.values()):
            # new parameters: graphs on the old ones hold stale addresses
            self._graphs.clear()
        t0 = time.perf_counter()
        self._graphs[sig] = _Graph(self.fn, fixed, inputs, self.pool,
                                   self.device)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return out
