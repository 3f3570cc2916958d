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
  * one graph memory pool is shared by a server's programs (``pool``):
    their outputs stay alive in the programs, and replays run in order
    on one stream, so intermediates may share memory;
  * kernel launch counts (``kops.launch_counts``) and dispatch records
    (``kops.record_dispatches``) are counted in Python at call time, so a
    replay would count nothing: a graph keeps the counts and records its
    capture made, takes them back out of the ambient ones, and adds them
    again at each replay. A captured run counts exactly as an eager one.

``disable_capture()`` runs the same step functions eagerly (the
counterpart of ``jax.disable_jit``): tests and ``chip_smoke.py`` hold
captured against eager with it. A model whose step syncs with the host
cannot be captured: the MoE layer asks which experts its tokens chose
(``models/moe.py``), so such a model's programs run eagerly and its
server reports ``captured: false``. A capture that fails raises;
nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops

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


def syncs_with_host(cfg: ModelConfig) -> bool:
    """True when a step of ``cfg`` waits on the host mid-step: the MoE
    layer copies its routing to the host (``models/moe.py``), which a
    graph cannot hold."""
    return bool(cfg.num_experts)


def captures(device: torch.device, cfg: ModelConfig) -> bool:
    """Whether a server of ``cfg`` on ``device`` replays graphs: on the
    card, capture enabled, and a step that never syncs with the host."""
    return (device.type == "cuda" and capture_enabled()
            and not syncs_with_host(cfg))


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
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()


class _Graph:
    """One capture: static inputs, outputs, and the launch counts and
    dispatch records the capture made."""

    def __init__(self, fn: Callable, fixed: tuple, inputs: dict, pool,
                 device: torch.device) -> None:
        self.fixed = fixed                 # holds the addresses alive
        self.static = _clone(inputs)
        self.graph = torch.cuda.CUDAGraph()
        before = build.launches.copy()
        self.records: list = []
        try:
            with kops.record_dispatches(self.records):
                with _capturing(self.graph, pool, device):
                    self.out = fn(fixed, **self.static)
        finally:
            # the capture launched nothing: its counts belong to replays
            self.launches = build.launches - before
            build.launches.subtract(self.launches)

    def replay(self, inputs: dict) -> Any:
        _copy_into(self.static, inputs)
        self.graph.replay()
        build.launches.update(self.launches)
        kops.extend_dispatches(self.records)
        return tree.map_leaves(lambda t: t.clone(), self.out)


class Program:
    """A step function run eagerly, or captured and replayed on the card
    (see the module docstring). ``capturable=False`` keeps it eager on
    every device (a step that syncs with the host)."""

    def __init__(self, fn: Callable, *, device: torch.device, pool=None,
                 capturable: bool = True) -> None:
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.capturable = capturable
        self._graphs: dict[tuple, _Graph] = {}
        self.captures = 0
        self.replays = 0
        self.eager_calls = 0

    @property
    def captured(self) -> bool:
        """Whether a call here replays a graph."""
        return (self.device.type == "cuda" and self.capturable
                and capture_enabled())

    def __call__(self, fixed: tuple, **inputs) -> Any:
        if not self.captured:
            self.eager_calls += 1
            return self.fn(fixed, **inputs)
        sig = _signature(fixed, inputs)
        graph = self._graphs.get(sig)
        if graph is not None:
            self.replays += 1
            return graph.replay(inputs)
        # warm-up: the real call, eager; then the capture
        self.eager_calls += 1
        out = self.fn(fixed, **inputs)
        if any(g.fixed[0] is not fixed[0] for g in self._graphs.values()):
            # new parameters: graphs on the old ones hold stale addresses
            self._graphs.clear()
        self._graphs[sig] = _Graph(self.fn, fixed, inputs, self.pool,
                                   self.device)
        self.captures += 1
        return out
