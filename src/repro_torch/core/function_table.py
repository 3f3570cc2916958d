"""The host function table (paper §3.3), as torch callables.

Mirror of ``repro.core.function_table``: the same 15 names and
``rowwise`` flags as its ``make_default_table``. Each default entry also
carries ``device_id``, the compile-time id of its kernel-side
counterpart (``csrc/activation.cuh``): elementwise entries are applied
by ``apply_activation``, which every kernel takes; the rowwise
``softmax`` and ``rmsnorm`` are taken only by the standalone activation
kernel (``csrc/activation.cu``), and the fused kernels' wrappers reject
rowwise entries.

A function registered at run time reaches the kernels through its
``device_expr``: a CUDA C++ expression in a ``float x``, for example
``"x * tanhf(log1pf(expf(x)))"`` for mish. The build compiles the
unchanged kernel sources once more with that expression as the
reserved id ``USER_ACTIVATION_ID`` (``kernels/build.py``), so a new
activation is one table row and no edit to any ``.cu`` file::

    table.register("mish", lambda t: t * torch.tanh(F.softplus(t)),
                   device_expr="x * tanhf(log1pf(expf(x)))")

This is where the port differs from the JAX package: a Pallas kernel
traces any ``jnp`` callable, while a CUDA kernel cannot run a torch
callable, so the port needs the expression beside it, and the two must
compute the same function. An entry with neither an id nor an
expression serves the plain versions only; on a CUDA tensor its
wrapper raises.

Each entry also carries its host cost, ``vpu_ops_per_element``, which
the analytical engine and the planner read (``cost``); it defaults to
the model's ``constants.FLEXIBLE_OP_COST`` for the name. The table is
versioned as the JAX one: every mutation bumps ``version``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import torch

from repro_torch.core import constants

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FunctionEntry:
    """One row of the function table.

    Attributes:
      name: table key (the "function pointer" written into the Sidebar).
      fn: pure elementwise/rowwise torch callable.
      rowwise: True if the function needs a full row (softmax, norms).
      device_id: id of the kernel-side implementation, or None.
      device_expr: CUDA C++ expression in ``float x`` that the kernels
        compile for an entry without an id, or None.
      vpu_ops_per_element: host-side vector-op cost (drives the energy
        and latency model; encodes relu-vs-softplus asymmetry).
    """

    name: str
    fn: Callable[..., Tensor]
    rowwise: bool = False
    device_id: int | None = None
    device_expr: str | None = None
    vpu_ops_per_element: float = constants.DEFAULT_FLEXIBLE_OP_COST


# the kernel-side id of every entry registered with a ``device_expr``
# (``kUser`` in csrc/activation.cuh): a library built for that expression
# takes this id to it
USER_ACTIVATION_ID = 15


def _check_device_expr(expr: str, rowwise: bool,
                       device_id: int | None) -> None:
    if device_id is not None:
        raise ValueError("an entry has a device_id or a device_expr, "
                         "not both")
    if rowwise:
        raise ValueError("a device_expr is elementwise (one float x); a "
                         "rowwise entry cannot have one")
    if not expr.strip() or any(c in expr for c in ";#{}\n"):
        raise ValueError(f"device_expr must be one C++ expression in "
                         f"float x, got {expr!r}")


class FunctionTable:
    """Driver-style registry of host ("flexible") functions
    (thread-safe, versioned: ``version`` counts mutations)."""

    def __init__(self) -> None:
        self._entries: dict[str, FunctionEntry] = {}
        self._lock = threading.Lock()
        self._version = 0

    def register(self, name: str, fn: Callable[..., Tensor], *,
                 rowwise: bool = False, device_id: int | None = None,
                 device_expr: str | None = None,
                 vpu_ops_per_element: float | None = None,
                 overwrite: bool = False) -> FunctionEntry:
        if device_expr is not None:
            _check_device_expr(device_expr, rowwise, device_id)
        cost = (vpu_ops_per_element if vpu_ops_per_element is not None
                else constants.FLEXIBLE_OP_COST.get(
                    name, constants.DEFAULT_FLEXIBLE_OP_COST))
        with self._lock:
            if name in self._entries and not overwrite:
                raise ValueError(
                    f"function {name!r} already registered; pass "
                    "overwrite=True to hot-swap")
            entry = FunctionEntry(name, fn, rowwise, device_id, device_expr,
                                  cost)
            self._entries[name] = entry
            self._version += 1
            return entry

    def unregister(self, name: str) -> None:
        with self._lock:
            del self._entries[name]
            self._version += 1

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> FunctionEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"flexible function {name!r} not in the function table; "
                f"known: {sorted(self._entries)}") from None

    def lookup(self, name: str) -> Callable[..., Tensor]:
        return self[name].fn

    def cost(self, name: str) -> float:
        return self[name].vpu_ops_per_element

    def names(self) -> list[str]:
        return sorted(self._entries)

    @property
    def version(self) -> int:
        return self._version


# ---------------------------------------------------------------------------
# Default table. Each function computes in the dtype it is given, like
# the jnp entries; the kernel applies them to its fp32 ``h`` tile.
# ---------------------------------------------------------------------------


def _heaviside(x: Tensor) -> Tensor:
    return (x > 0).to(x.dtype)


def _relu(x: Tensor) -> Tensor:
    return torch.clamp_min(x, 0.0)


def _leaky_relu(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, 0.01 * x)


def _elu(x: Tensor) -> Tensor:
    safe = torch.clamp_max(x, 0.0)
    return torch.where(x > 0, x, torch.exp(safe) - 1.0)


def _softplus(x: Tensor) -> Tensor:
    # logaddexp(x, 0), numerically stable
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _squared_relu(x: Tensor) -> Tensor:
    r = torch.clamp_min(x, 0.0)
    return r * r


def _silu(x: Tensor) -> Tensor:
    return (x * torch.sigmoid(x.float())).to(x.dtype)


def _gelu(x: Tensor) -> Tensor:
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)


def _softmax(x: Tensor) -> Tensor:
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def _rmsnorm(x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


def _exp_decay(x: Tensor) -> Tensor:
    return torch.exp(-torch.exp(x.float())).to(x.dtype)


# name -> (fn, rowwise, device id). The ids are those of
# csrc/activation.cuh (``apply_activation``'s ``case`` labels, and
# ``kSoftmax``/``kRmsnorm``): keep the two in step.
_DEFAULTS = (
    ("identity", lambda x: x, False, 0),
    ("heaviside", _heaviside, False, 1),
    ("relu", _relu, False, 2),
    ("leaky_relu", _leaky_relu, False, 3),
    ("elu", _elu, False, 4),
    ("tanh", torch.tanh, False, 5),
    ("sigmoid", torch.sigmoid, False, 6),
    ("softplus", _softplus, False, 7),
    ("squared_relu", _squared_relu, False, 8),
    ("silu", _silu, False, 9),
    ("gelu", _gelu, False, 10),
    ("abs", torch.abs, False, 11),
    ("softmax", _softmax, True, 13),
    ("rmsnorm", _rmsnorm, True, 14),
    ("exp_decay", _exp_decay, False, 12),
)


def make_default_table() -> FunctionTable:
    t = FunctionTable()
    for name, fn, rowwise, device_id in _DEFAULTS:
        t.register(name, fn, rowwise=rowwise, device_id=device_id)
    return t


DEFAULT_TABLE = make_default_table()
