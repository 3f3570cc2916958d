"""Grouped expert product of the MoE layer: ``out[r] = a[r] @ w[e(r)]``
in fp32 for rows sorted by expert (the products of ``_expert_mlp`` in
``repro.models.moe``, which the JAX package leaves to XLA: one
``jnp.dot(..., preferred_element_type=float32)`` per expert).

``grouped_mm(a, w, offsets)`` takes a (n, K), the expert stack w
(E, K, N) and ``offsets`` (E + 1,) int32: expert e owns rows
``[offsets[e], offsets[e + 1])``; rows from ``offsets[E]`` on belong to
none and come out zero. The groups stay on the device: nothing is read
on the host, the launch depends on (n, E, K, N) alone (``plan``), so a
CUDA graph can hold the call, and an expert no row chose is never read.

For CUDA tensors it launches the hand-written Hopper kernel
(``csrc/moe_experts.cu``; its header says what bounds it) on one of two
routes (``route``): "tc", bf16 on the tensor cores, and "fma", fp32 and
bf16 of any other width. The "tc" route has two tile shapes, chosen by
``tc_tiles(n, E, K, N)``: "narrow" (at most ``NARROW_GROUP_ROWS`` rows a
group on average: decode and staging rounds), the swapped product on
wgmma with tiles of up to 32 rows of a group in slices of 8, and K split
into ``narrow_splits(K)`` ranges summed in a fixed order; and "wide"
(longer groups: prefill chunks, training micro-batches), 128-row x
256-column tiles with the tokens as the wgmma's M, in clusters of four
column tiles sharing one box of ``a`` and in bands of column tiles
(``band_tile``). A row tile holds the rows of one group;
``slot_start`` and ``tile_of`` mirror how a block finds its tile from
``offsets``, and ``slot_count`` bounds the tiles:
``n // rows + min(E, n)``. Within one shape a row's result does not
depend on the other rows (a row alone equals its row in a batch on the
narrow shape); across the two shapes its bits may differ.

For CPU tensors it takes the plain version, ``grouped_mm_plain``: every
expert's product over all rows, each row keeping its own expert's
(fixed-order ``ref.dot``, so a row's result depends on its row alone).
There is no fallback between the two: a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dot

Tensor = torch.Tensor

ROUTES = {"fma": 0, "tc": 1}
SHAPES = {"narrow": 0, "wide": 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

# the kernel's tiles (csrc/moe_experts.cu): token rows and output columns
# of a block; a narrow tile's rows go in slices of ``NARROW_SLICE`` (the
# wgmma's N) over each 128-deep stage of its expert's weights
FMA_ROWS, FMA_COLS = 16, 64
NARROW_ROWS, NARROW_COLS, NARROW_DEPTH, NARROW_SLICE = 32, 64, 128, 8
WIDE_ROWS, WIDE_COLS = 128, 256
# wide blocks run in clusters of WIDE_CLUSTER column tiles (sharing one
# box of a), in bands of WIDE_BAND column tiles (``band_tile``)
WIDE_BAND, WIDE_CLUSTER = 8, 4
# narrow while the groups average at most this many rows (n / min(E, n)):
# decode and the staging rounds of the served configs (up to 4 rows a
# group) stay on the shape where a row alone equals its row in a batch.
# chip_smoke.py phase 1 times both shapes across it (NVIDIA H100 80GB
# HBM3, 700 W): at llama4-scout's gate widths narrow leads at 1 row a
# group, the two tie at 2 and wide leads from 4; at deepseek-v3's, wide
# leads at every height
NARROW_GROUP_ROWS = 4
# no narrow block streams more contraction rows than this
SPLIT_DEPTH = 2048


@dataclasses.dataclass(frozen=True)
class TcTiles:
    """The "tc" route's shape: ``shape`` "narrow" or "wide", token
    ``rows`` and output ``cols`` of a block, and the K ``splits``."""
    shape: str
    rows: int
    cols: int
    splits: int


def route(a: Tensor, w: Tensor) -> str:
    """"tc" for bf16 operands whose contraction and output widths (K, N)
    are multiples of 8 at 16-byte aligned addresses; else "fma"."""
    k, n = w.shape[-2], w.shape[-1]
    if (a.dtype == w.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tc"
    return "fma"


def narrow_splits(k: int) -> int:
    """K ranges of the narrow shape: whole 128-deep chunks, no range
    deeper than ``SPLIT_DEPTH``. It depends on K alone, so a row gets the
    same ranges alone and in any batch."""
    chunks = -(-k // NARROW_DEPTH)
    return max(1, min(chunks, -(-k // SPLIT_DEPTH)))


def tc_tiles(n: int, e: int, k: int, nout: int) -> TcTiles:
    """The "tc" route's shape for n rows over E experts of (K, N): narrow
    while ``n <= NARROW_GROUP_ROWS * min(E, n)`` (a row alone always),
    else wide. A function of (n, E, K, N) alone, never of the groups."""
    del nout  # every shape takes any N (ragged column tiles are masked)
    if n <= NARROW_GROUP_ROWS * min(e, n):
        return TcTiles("narrow", NARROW_ROWS, NARROW_COLS, narrow_splits(k))
    return TcTiles("wide", WIDE_ROWS, WIDE_COLS, 1)


def slot_count(n: int, e: int, rows: int) -> int:
    """Row slots of the grid: at most min(E, n) groups hold rows, so
    their tiles of ``rows`` rows fit in ``n // rows + min(E, n)``."""
    return n // rows + min(e, n)


def slot_start(offsets: Sequence[int], e: int, rows: int) -> int:
    """The first slot of group e's tiles (``e`` in [0, E]); it never
    decreases with e and leaves each group room for its tiles."""
    o = int(offsets[e])
    return o // rows + min(e, o)


def tile_of(offsets: Sequence[int], slot: int, rows: int
            ) -> tuple[int, int, int] | None:
    """(expert, first row, rows) of the tile in ``slot``, or None: the
    group is the last e with ``slot_start(e) <= slot``, and the tile its
    (slot - slot_start(e))-th slice of ``rows`` rows from its first row
    (the kernel's ``find_tile``)."""
    e_count = len(offsets) - 1
    starts = [slot_start(offsets, e, rows) for e in range(e_count + 1)]
    e = bisect.bisect_right(starts, slot) - 1
    if e == e_count:
        return None
    o, c = int(offsets[e]), int(offsets[e + 1]) - int(offsets[e])
    j = slot - starts[e]
    if j * rows >= c:
        return None
    return e, o + j * rows, min(rows, c - j * rows)


def band_tile(b: int, slots: int, ncols: int) -> tuple[int, int]:
    """(slot, column tile) of wide block ``b``: clusters of WIDE_CLUSTER
    blocks on neighbouring column tiles of one slot (the grid rounds the
    columns up to whole clusters), in bands of WIDE_BAND column tiles (the
    last one narrower), slot by slot within a band, its clusters fastest
    (the kernel's ``band_tile``)."""
    units = -(-ncols // WIDE_CLUSTER)
    band = WIDE_BAND // WIDE_CLUSTER
    u, rank = divmod(b, WIDE_CLUSTER)
    c0 = u // (slots * band) * band
    width = min(band, units - c0)
    r = u - c0 * slots
    return r // width, (c0 + r % width) * WIDE_CLUSTER + rank


def split_ranges(k: int, splits: int) -> list[tuple[int, int]]:
    """The contraction rows [k0, k1) of each narrow split: whole 128-deep
    chunks, ranges within one chunk of each other, in split order."""
    chunks = -(-k // NARROW_DEPTH)
    q, rem = divmod(chunks, splits)
    out, c = [], 0
    for z in range(splits):
        cn = q + (1 if z < rem else 0)
        out.append((c * NARROW_DEPTH, min(k, (c + cn) * NARROW_DEPTH)))
        c += cn
    return out


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch: the route, the tc shape (None on "fma"), the
    grid (slots, column tiles, splits) and the fp32 workspace of a split
    (None without one)."""
    route: str
    tiles: TcTiles | None
    grid: tuple[int, int, int]
    workspace: tuple[int, int, int] | None


def plan(n: int, e: int, k: int, nout: int, route_: str,
         tiles: TcTiles | None = None) -> Plan:
    """The launch of ``route_`` for (n, E, K, N); ``tiles`` overrides the
    tc shape of ``tc_tiles`` (it must be one the kernel has)."""
    if route_ == "fma":
        if tiles is not None:
            raise ValueError("moe_grouped_mm: the fma route has no tc shape")
        return Plan("fma", None, (slot_count(n, e, FMA_ROWS),
                                  -(-nout // FMA_COLS), 1), None)
    if tiles is None:
        tiles = tc_tiles(n, e, k, nout)
    chunks = -(-k // NARROW_DEPTH)
    if tiles.shape == "narrow":
        ok = ((tiles.rows, tiles.cols) == (NARROW_ROWS, NARROW_COLS)
              and 1 <= tiles.splits <= max(1, chunks))
    else:
        ok = (tiles.shape == "wide" and tiles.splits == 1
              and (tiles.rows, tiles.cols) == (WIDE_ROWS, WIDE_COLS))
    if not ok:
        raise ValueError(f"moe_grouped_mm: no tc shape {tiles}")
    ws = (tiles.splits, n, nout) if tiles.splits > 1 else None
    return Plan("tc", tiles, (slot_count(n, e, tiles.rows),
                              -(-nout // tiles.cols), tiles.splits), ws)


def group_of_rows(offsets: Tensor, n: int) -> Tensor:
    """(n,) expert of each row; E for rows past ``offsets[E]``."""
    rows = torch.arange(n, device=offsets.device, dtype=offsets.dtype)
    return torch.searchsorted(offsets[1:], rows, right=True)


def grouped_mm_plain(a: Tensor, w: Tensor, offsets: Tensor) -> Tensor:
    """The plain version: (n, N) fp32, each row ``a[r] @ w[e(r)]`` (zero
    past the groups), every expert's product taken over all rows."""
    group = group_of_rows(offsets, a.shape[0])[:, None]
    out = torch.zeros((a.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for e in range(w.shape[0]):
        out = torch.where(group == e, dot(a, w[e]), out)
    return out


def _check(a: Tensor, w: Tensor, offsets: Tensor) -> None:
    if a.ndim != 2 or w.ndim != 3 or a.shape[1] != w.shape[1]:
        raise ValueError(f"grouped_mm takes a (n, K) and w (E, K, N), got "
                         f"a{tuple(a.shape)} w{tuple(w.shape)}")
    if offsets.shape != (w.shape[0] + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be ({w.shape[0] + 1},) int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")


def grouped_mm(a: Tensor, w: Tensor, offsets: Tensor) -> Tensor:
    """(n, N) fp32: row r of ``a`` times its expert's matrix of ``w``
    (``launch`` under the plan of the operands' shapes)."""
    _check(a, w, offsets)
    n, k = a.shape
    e, _, nout = w.shape
    return launch(a, w, offsets, plan(n, e, k, nout, route(a, w)))


def launch(a: Tensor, w: Tensor, offsets: Tensor, p: Plan) -> Tensor:
    """``grouped_mm`` under the plan ``p``: ``plan``'s for the operands,
    with the tc shape it was given (chip_smoke.py times both shapes
    this way). CPU tensors take the plain version."""
    _check(a, w, offsets)
    n, k = a.shape
    e, _, nout = w.shape
    if p != plan(n, e, k, nout, route(a, w), p.tiles):
        raise ValueError(f"moe_grouped_mm: {p} is not a plan of these "
                         "operands")
    if not a.is_cuda:
        return grouped_mm_plain(a, w, offsets)
    dtype = build.check_operands("moe_grouped_mm", a, w)
    if offsets.device != a.device or not offsets.is_contiguous():
        raise ValueError("moe_grouped_mm: offsets must be contiguous on the "
                         "operands' device")
    dev = a.device
    if n == 0 or p.workspace is None:
        out = torch.zeros((n, nout), dtype=torch.float32, device=dev)
        ws = None
    else:  # the reduce writes every element of out
        out = torch.empty((n, nout), dtype=torch.float32, device=dev)
        ws = torch.zeros(p.workspace, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = build.entry("moe_grouped_mm", "moe_grouped_mm_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = SHAPES[p.tiles.shape] if p.tiles else 0
    err = fn(a.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), n, k, nout, e, dtype,
             ROUTES[p.route], shape, p.grid[2], stream)
    build.check(err, "moe_grouped_mm")
    build.launches["moe_grouped_mm"] += 1
    return out
