"""Tiled product with a function-table epilogue: c = f(a @ b) (port of
``repro.kernels.sidebar_matmul``).

``sidebar_matmul`` launches the hand-written Hopper kernel
(``csrc/sidebar_matmul.cu``; its header says what bounds it and how it
is built) for CUDA tensors and takes the plain PyTorch version,
``sidebar_matmul_plain`` (= ``ref.sidebar_matmul_ref``), for CPU
tensors. The kernel has two routes, chosen by the MLP kernels' rule of
shape (``sidebar_mlp.route``): "tc" (bf16 on the tensor cores, the MLP
body's producer without its consumers) and "fma" (the CUDA cores: fp32,
and bf16 widths TMA cannot stride). Any M, K and N: there is no TPU
tile rule. The partition (``plan``) is a pure function of (M, K, N, the
epilogue, the route). The epilogue is any elementwise table entry, one
registered at run time with a ``device_expr`` included. A CUDA tensor
never reaches the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import build
from repro_torch.kernels.ref import sidebar_matmul_ref as sidebar_matmul_plain
from repro_torch.kernels.sidebar_mlp import ROUTES, SMS, route

# fma route (csrc/sidebar_matmul.cu ``matmul_tile``): rows per row panel,
# the column tile and the contraction chunk (a K range is a whole number
# of chunks); aim for two blocks per SM of an H100 (132 SMs)
BLOCK_M = 16
BLOCK_N = 128
BLOCK_K = 64
TARGET_BLOCKS = 2 * SMS
# tc route (``matmul_tc``): a block owns TC_BLOCK_N output columns of
# one panel of up to TC_MAX_PANEL rows, over a K range of whole
# TC_BLOCK_K-deep chunks (one TMA stage each); its ring leaves room for
# TC_BLOCKS_PER_SM blocks an SM (the library exports its shared memory:
# ``smem_bytes``). A block's fixed cost (ring fill, epilogue) counts as
# TC_FILL_CHUNKS chunks of streaming when the K split is chosen
TC_BLOCK_N = 64
TC_BLOCK_K = 128
TC_MAX_PANEL = 64
TC_BLOCKS_PER_SM = 2
TC_FILL_CHUNKS = 2

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def k_range(m: int, k: int, n: int, identity: bool) -> int:
    """The K range one block of the fma route owns. Under the identity
    epilogue K is split so that (row panels x column tiles x K splits)
    fills the card; under any other epilogue one block owns all of K, so
    the pre-activation sum never leaves the block."""
    whole = max(BLOCK_K, -(-k // BLOCK_K) * BLOCK_K)
    if not identity:
        return whole
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N)
    splits = max(1, -(-TARGET_BLOCKS // tiles))
    kr = -(-k // splits)
    return min(whole, max(BLOCK_K, -(-kr // BLOCK_K) * BLOCK_K))


def tc_panel_rows(m: int) -> int:
    """Token rows of one panel of the tc route: the N of its m64nNk16
    products (8, 16, 32, or 64 above 32 rows and for every panel above
    64 rows)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 \
        else TC_MAX_PANEL


def tc_splits(panels: int, tiles: int, chunks: int, identity: bool) -> int:
    """Chunks of one K range of the tc route. Under any epilogue but the
    identity: all of them. Under the identity: the range that minimises
    (waves of TC_BLOCKS_PER_SM blocks on every SM) x (its chunks + the
    block's fixed cost), the fewest splits among equals."""
    if not identity:
        return chunks
    slots = TC_BLOCKS_PER_SM * SMS

    def cost(per: int) -> tuple[int, int]:
        blocks = panels * tiles * -(-chunks // per)
        return -(-blocks // slots) * (per + TC_FILL_CHUNKS), -per

    return min(range(1, chunks + 1), key=cost)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """What a launch is given and what it runs: the route, the rows of a
    panel, the row panels, the column tiles, the K splits and the K
    range of one split."""

    route: str
    panel_rows: int
    panels: int
    tiles: int
    splits: int
    k_range: int


def plan(m: int, k: int, n: int, identity: bool, route: str) -> MatmulPlan:
    """The partition of c = f(a @ b), a (M, K) and b (K, N), on
    ``route``: a pure function of its arguments. K is split across
    blocks only under the identity epilogue."""
    if route == "fma":
        kr = k_range(m, k, n, identity)
        return MatmulPlan("fma", BLOCK_M, -(-m // BLOCK_M),
                          -(-n // BLOCK_N), max(1, -(-k // kr)), kr)
    if route != "tc" or k < 1:
        raise ValueError(f"no tc partition of {m}x{k}x{n} on {route!r}")
    rows = tc_panel_rows(m)
    panels, tiles = -(-m // rows), -(-n // TC_BLOCK_N)
    chunks = -(-k // TC_BLOCK_K)
    per = tc_splits(panels, tiles, chunks, identity)
    return MatmulPlan("tc", rows, panels, tiles, -(-chunks // per),
                      per * TC_BLOCK_K)


def operand_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route of CUDA operands: ``sidebar_mlp.route``'s rule, with a
    contraction of K = 0 on the fma route (no TMA box to load)."""
    return route(a, b) if a.shape[1] else "fma"


def smem_bytes(m: int, dtype: torch.dtype, route: str) -> int:
    """Shared memory one block of ``route`` takes at M rows, from the
    built library: the one place that knows the layout."""
    fn = build.entry("sidebar_matmul", "sidebar_matmul_smem",
                     [ctypes.c_int] * 3)
    rows = tc_panel_rows(m) if route == "tc" else BLOCK_M
    return fn(rows, build.DTYPES[dtype], ROUTES[route])


def sidebar_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    activation: str | Callable = "identity",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """f(a @ b) with a (M, K), b (K, N); the result in a's type."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("sidebar_matmul takes 2-D operands")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"contraction mismatch: a{tuple(a.shape)} b{tuple(b.shape)}")
    if not a.is_cuda:
        return sidebar_matmul_plain(a, b, activation, table)
    dtype = build.check_operands("sidebar_matmul", a, b)
    act, expr = build.kernel_activation("sidebar_matmul", activation,
                                        table, a.device)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    p = plan(m, k, n, act == 0, operand_route(a, b))
    ws = torch.empty((p.splits * m * n if p.splits > 1 else 0,),
                     dtype=torch.float32, device=a.device)
    fn = build.entry("sidebar_matmul", "sidebar_matmul_launch", _ARGTYPES,
                     expr)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), m, k,
             n, p.panel_rows, p.k_range, act, dtype, ROUTES[p.route], stream)
    build.check(err, "sidebar_matmul")
    build.launches["sidebar_matmul"] += 1
    return c
