"""Fused Sidebar MLP: y = f(x @ W1) @ W2 (port of
``repro.kernels.sidebar_mlp``: ``sidebar_mlp`` and
``sidebar_mlp_pipelined``).

Both launch one ring (``csrc/sidebar_ring.cuh``): ``sidebar_mlp``, the
serial kernel (``csrc/sidebar_mlp.cu``), with one f(h) slot, and
``sidebar_mlp_pipelined`` (``csrc/sidebar_mlp_pipelined.cu``) with a
T-deep ring; each source's header says what bounds it. Both get the
same partition (``ring_plan``) and so, for the same (M, F), the same
bits at every depth. The ring has two bodies, chosen by ``route``, a
pure function of dtype, widths and alignment that the gated MLP
(``sidebar_gated_mlp``) shares: "tc" (bf16 on the tensor cores,
``csrc/sidebar_tc.cuh``) and "fma" (the CUDA cores). It is a route
chosen by shape, not a fallback: every shape computes on the card, a
CUDA tensor never reaches the plain version, and a failed build or
launch raises. For CPU tensors both wrappers take the plain PyTorch
version, ``sidebar_mlp_plain`` (= ``ref.sidebar_mlp_ref``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import build
from repro_torch.kernels.ref import sidebar_mlp_ref as sidebar_mlp_plain

# the ring's two bodies, by their code in the C entry points
# (csrc/common.cuh ``Route``)
ROUTES = {"fma": 0, "tc": 1}

# tc route: a thread-block cluster of ``cluster_size(m)`` blocks shares
# one F range, walked in sub-tiles (ring slots) of cluster_size x SHARE_F
# columns; a panel holds 8 token rows (M <= 8), 16 (M <= 16) or 32 (on
# clusters of 8). Clusters aim to cover the H100's SMs
SHARE_F = 64
SMS = 132
# fma route (plain FMA): 16-row panels, F columns of one ring slot; a
# block owns at least FMA_MIN_SUBTILES of them, so a ring of depth up to
# 4 has sub-tiles to pipeline even at decode; splits aim for two blocks
# per SM
FMA_PANEL_ROWS = 16
FMA_SUBTILE_F = 64
FMA_MIN_SUBTILES = 4
FMA_TARGET_BLOCKS = 2 * SMS

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_PIPE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 4


def route(*operands: torch.Tensor) -> str:
    """The body an MLP kernel runs its operands on: "tc" for bf16
    operands whose rows TMA can stride (every last dim — D, F, D2 — a
    multiple of 8) at 16-byte aligned addresses; "fma" for everything
    else (fp32, and bf16 of any other width or alignment)."""
    if all(t.dtype == torch.bfloat16 and t.shape[-1] % 8 == 0
           and t.data_ptr() % 16 == 0 for t in operands):
        return "tc"
    return "fma"


def tokens_per_panel(m: int) -> int:
    """Token rows of one panel of the tc route: the N of its m64nNk16
    tensor-core products (8 at decode, 16, or 32 above 16)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


def cluster_size(m: int) -> int:
    """Blocks of a cluster of the tc route: 8 beside 32-row panels (a
    consumer then holds D2 / 16 columns of 64 x 32 accumulators), else
    4."""
    return 8 if tokens_per_panel(m) == 32 else 4


def subtile_f(m: int) -> int:
    """F columns of one ring slot of the tc route."""
    return cluster_size(m) * SHARE_F


def f_range_pipelined(m: int, f: int) -> int:
    """Width of the F range one cluster of the tc route owns: the panels'
    clusters together aim at one block per SM (each panel gets an equal
    share of them), in whole sub-tiles. It depends on M and F only —
    never on the ring depth — which keeps the output bitwise equal
    across depths."""
    panels = max(1, -(-m // tokens_per_panel(m)))
    clusters = max(1, SMS // cluster_size(m) // panels)
    fr = -(-f // clusters)
    return -(-fr // subtile_f(m)) * subtile_f(m)


def f_range_fma(m: int, f: int) -> int:
    """Width of the F range one block of the fma route owns: enough
    splits to fill the card, in whole 64-column sub-tiles, but at least
    ``FMA_MIN_SUBTILES`` of them; M and F only, as above."""
    panels = max(1, -(-m // FMA_PANEL_ROWS))
    splits = max(1, -(-FMA_TARGET_BLOCKS // panels))
    fr = -(-f // splits)
    fr = -(-fr // FMA_SUBTILE_F) * FMA_SUBTILE_F
    return max(FMA_MIN_SUBTILES * FMA_SUBTILE_F, fr)


def ring_slots(m: int, f: int, depth: int, route: str = "tc") -> int:
    """The depth the wrapper asks of the kernel: a ring deeper than the
    sub-tiles one cluster (tc) or block (fma) owns never holds more than
    those. The tc launch caps it again at the slots its shared memory
    holds (``csrc`` ``Layout::MAX_SLOTS``); the output depends on
    neither cap."""
    if depth < 1:
        raise ValueError(f"ring depth must be >= 1, got {depth}")
    if route == "fma":
        return min(depth, f_range_fma(m, f) // FMA_SUBTILE_F)
    return min(depth, f_range_pipelined(m, f) // subtile_f(m))


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """What a launch of the ring is given: the route, the token rows of a
    panel, the blocks of a cluster (1 on the fma route), the F range of
    one cluster or block, the F splits of a panel and the ring slots."""

    route: str
    panel_rows: int
    cluster_size: int
    f_range: int
    splits: int
    slots: int


def ring_plan(m: int, f: int, depth: int, route: str) -> RingPlan:
    """The ring's partition at M token rows, F columns and ``depth`` on
    ``route``: every field but ``slots`` depends on (M, F, route) only."""
    if route == "fma":
        rows, c, fr = FMA_PANEL_ROWS, 1, f_range_fma(m, f)
    else:
        rows, c, fr = tokens_per_panel(m), cluster_size(m), \
            f_range_pipelined(m, f)
    return RingPlan(route, rows, c, fr, -(-f // fr),
                    ring_slots(m, f, depth, route))


def serial_plan(m: int, f: int, route: str) -> RingPlan:
    """The serial kernel's partition: the ring's at depth 1 (one f(h)
    slot), which makes its output the ring's at every depth."""
    return ring_plan(m, f, 1, route)


def pipelined_smem_bytes(m: int, f: int, depth: int, route: str,
                         dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory one block of the ring kernel requests (its
    stages, ring and mbarriers), from the built library: the one place
    that knows the layout."""
    fn = build.entry("sidebar_mlp_pipelined", "sidebar_mlp_pipelined_smem",
                     _SMEM_ARGTYPES)
    return fn(m, ring_slots(m, f, depth, route), build.DTYPES[dtype],
              ROUTES[route])


def _kernel_operands(name: str, x, w1, w2, activation, table):
    """Shapes, and for CUDA operands the kernel-side activation (id,
    device_expr) after the checks every MLP kernel wrapper makes; None
    for CPU operands (the plain version serves them)."""
    if x.ndim != 2 or w1.ndim != 2 or w2.ndim != 2:
        raise ValueError(f"{name} takes 2-D operands")
    m, d = x.shape
    d1, f = w1.shape
    f2, d2 = w2.shape
    if d != d1 or f != f2:
        raise ValueError(
            f"shape mismatch: x{tuple(x.shape)} w1{tuple(w1.shape)} "
            f"w2{tuple(w2.shape)}")
    if not x.is_cuda:
        return (m, d, f, d2), None
    build.check_operands(name, x, w1, w2)
    return (m, d, f, d2), build.kernel_activation(name, activation, table,
                                                  x.device)


def _launch_ring(name: str, symbol: str, argtypes, x, w1, w2, shapes, act,
                 depth: int | None) -> torch.Tensor:
    """Launch kernel ``name``'s ring on CUDA operands: the serial kernel
    (``depth`` None: one slot) or the pipelined one at ``depth``."""
    m, d, f, d2 = shapes
    y = torch.empty((m, d2), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    r = route(x, w1, w2)
    plan = (serial_plan(m, f, r) if depth is None
            else ring_plan(m, f, depth, r))
    ws = torch.empty((plan.splits * m * d2,), dtype=torch.float32,
                     device=x.device)
    fn = build.entry(name, symbol, argtypes, act[1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ring = () if depth is None else (plan.slots,)
    err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
             ws.data_ptr(), m, d, f, d2, plan.f_range, *ring, act[0],
             build.DTYPES[x.dtype], ROUTES[r], stream)
    build.check(err, name)
    build.launches[name] += 1
    return y


def sidebar_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """f(x @ w1) @ w2 with x (M, D), w1 (D, F), w2 (F, D2): the ring with
    one f(h) slot, bitwise equal to ``sidebar_mlp_pipelined``."""
    shapes, act = _kernel_operands("sidebar_mlp", x, w1, w2, activation,
                                   table)
    if act is None:
        return sidebar_mlp_plain(x, w1, w2, activation, table)
    return _launch_ring("sidebar_mlp", "sidebar_mlp_launch", _ARGTYPES, x,
                        w1, w2, shapes, act, None)


def sidebar_mlp_pipelined(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
    depth: int = 2,
) -> torch.Tensor:
    """f(x @ w1) @ w2 through a ``depth``-deep ring of f(h) sub-tiles;
    the same function as ``sidebar_mlp``, bitwise equal across depths."""
    shapes, act = _kernel_operands("sidebar_mlp_pipelined", x, w1, w2,
                                   activation, table)
    ring_slots(shapes[0], shapes[2], depth)   # a bad depth raises anywhere
    if act is None:
        return sidebar_mlp_plain(x, w1, w2, activation, table)
    return _launch_ring("sidebar_mlp_pipelined",
                        "sidebar_mlp_pipelined_launch", _PIPE_ARGTYPES, x,
                        w1, w2, shapes, act, depth)
