"""The tile list and the shapes of the grouped expert product
(``repro_torch.kernels.moe_experts``), on the CPU:

  * the tile mirror (``slot_start``, ``tile_of``): over seeded random
    groups (empty experts, one expert taking every row, rows past the
    groups, a single row) every grouped row falls in exactly one tile of
    one slot inside ``slot_count``, each tile inside its own group, and
    no tile belongs to an empty expert;
  * the launch depends on (n, E, K, N) alone: two groupings of the same
    n get the same plan (grid, shape, splits, workspace), and that grid
    holds every tile of either;
  * the narrow / wide rule at chip_smoke.py's MoE shapes, a row alone
    and the 4096-token cases; the split ranges and the workspace a split
    takes; the wide blocks' band order;
  * a torch model of the kernel's walk (tiles of the plan, K ranges in
    split order, summed in fp64) against the plain version;
  * a tc shape the kernel does not have, and a plan of other operands,
    are refused.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_experts as me

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke_cases(name: str) -> tuple:
    """A table of chip_smoke.py's, read from its source (the script needs
    a card to import)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name for t in node.targets)):
            return ast.literal_eval(node.value)
    raise LookupError(name)


def _offsets(rng, n: int, e: int, kind: str) -> list[int]:
    """(E + 1) group offsets over n rows: ``random`` (empty experts
    likely), ``one`` (a single expert takes every row), ``past`` (a few
    rows belong to no expert), ``empty`` (no rows grouped)."""
    if kind == "one":
        counts = np.zeros(e, np.int64)
        counts[rng.randint(e)] = n
    elif kind == "empty":
        counts = np.zeros(e, np.int64)
    else:
        grouped = n - (rng.randint(1, n + 1) if kind == "past" else 0)
        counts = np.bincount(rng.randint(0, e, size=grouped), minlength=e)
    return [0] + np.cumsum(counts).tolist()


GROUPINGS = [(n, e, kind, seed)
             for n, e in ((1, 1), (1, 256), (4, 16), (32, 256), (64, 16),
                          (300, 5), (512, 256), (1000, 3))
             for kind in ("random", "one", "past", "empty")
             for seed in (0, 1)]


@pytest.mark.parametrize("rows", [me.NARROW_ROWS, me.WIDE_ROWS, me.FMA_ROWS])
@pytest.mark.parametrize("n,e,kind,seed", GROUPINGS)
def test_every_grouped_row_in_exactly_one_tile(n, e, kind, seed, rows):
    off = _offsets(np.random.RandomState(seed), n, e, kind)
    slots = me.slot_count(n, e, rows)
    # the group starts never decrease and fit the grid
    starts = [me.slot_start(off, g, rows) for g in range(e + 1)]
    assert starts == sorted(starts) and starts[-1] <= slots
    seen = np.zeros(n, np.int64)
    for s in range(slots + 3):
        tile = me.tile_of(off, s, rows)
        if tile is None:
            continue
        assert s < slots
        g, row0, count = tile
        assert off[g] <= row0 and row0 + count <= off[g + 1]
        assert 1 <= count <= rows and off[g + 1] > off[g]
        assert (row0 - off[g]) % rows == 0
        seen[row0:row0 + count] += 1
    assert (seen[:off[-1]] == 1).all() and not seen[off[-1]:].any()


@pytest.mark.parametrize("n,e", [(1, 256), (32, 256), (64, 16), (512, 256),
                                 (4096, 16), (300, 5)])
def test_the_launch_depends_on_the_shapes_alone(n, e):
    """Two groupings of n rows: one plan (the wrapper reads no offsets),
    and its grid holds the tiles of both."""
    k, nout = 256, 192
    plans = []
    for seed, kind in ((0, "random"), (1, "one")):
        off = _offsets(np.random.RandomState(seed), n, e, kind)
        p = me.plan(n, e, k, nout, "tc")
        plans.append(p)
        tiles = [me.tile_of(off, s, p.tiles.rows) for s in range(p.grid[0])]
        rows = sum(t[2] for t in tiles if t is not None)
        assert rows == off[-1] == n
    assert plans[0] == plans[1]
    assert plans[0].tiles == me.tc_tiles(n, e, k, nout)


def test_the_shape_rule_at_the_served_shapes():
    """chip_smoke.py's decode and staging products and a row alone take
    the narrow shape; its 4096-token products the wide one."""
    for _, _, k, nout, e, top, t in _smoke_cases("MOE_CASES"):
        for n in (t * top, 1):
            tiles = me.tc_tiles(n, e, k, nout)
            assert tiles.shape == "narrow", (n, e)
            assert tiles.splits == me.narrow_splits(k)
    for _, _, k, nout, e, top, t in _smoke_cases("MOE_WIDE_CASES"):
        assert t == 4096
        assert me.tc_tiles(t * top, e, k, nout) == me.TcTiles(
            "wide", me.WIDE_ROWS, me.WIDE_COLS, 1)
    # the threshold itself, and a row alone whatever E
    for e in (1, 8, 16, 256):
        limit = me.NARROW_GROUP_ROWS * e
        assert me.tc_tiles(limit, e, 64, 64).shape == "narrow"
        assert me.tc_tiles(limit + 1, e, 64, 64).shape == "wide"
        assert me.tc_tiles(1, e, 64, 64).shape == "narrow"


def test_narrow_splits_and_workspace():
    """ceil(K / 2048) ranges of whole 128-deep chunks, within a chunk of
    each other, in order; a split plan zeroes (splits, n, N) fp32."""
    for k, want in ((64, 1), (2048, 1), (2056, 2), (5120, 3), (7168, 4),
                    (8192, 4)):
        splits = me.narrow_splits(k)
        assert splits == want
        ranges = me.split_ranges(k, splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(k0 % me.NARROW_DEPTH == 0 for k0, _ in ranges)
        depths = [k1 - k0 for k0, k1 in ranges]
        assert max(depths) <= me.SPLIT_DEPTH
        chunks = [-(-d // me.NARROW_DEPTH) for d in depths]
        assert max(chunks) - min(chunks) <= 1
    # deepseek-v3's decode gate (32 pairs, K 7168, N 2048): 4 ranges
    p = me.plan(32, 256, 7168, 2048, "tc")
    assert p.grid == (1 + 32, 2048 // me.NARROW_COLS, 4)
    assert p.workspace == (4, 32, 2048)
    # its down product (K 2048) and the wide shape take no workspace
    assert me.plan(32, 256, 2048, 7168, "tc").workspace is None
    assert me.plan(4096, 16, 5120, 8192, "tc").workspace is None
    assert me.plan(40, 8, 64, 64, "fma").workspace is None


@pytest.mark.parametrize("slots,ncols", [(1, 1), (48, 32), (512, 8),
                                         (5, 20), (3, 13), (7, 3)])
def test_wide_bands_visit_every_tile_once(slots, ncols):
    """The wide grid (column tiles rounded up to whole clusters) visits
    every (slot, column tile) once; a cluster's blocks share a slot and
    take neighbouring column tiles."""
    c = me.WIDE_CLUSTER
    blocks = slots * -(-ncols // c) * c
    seen = [me.band_tile(b, slots, ncols) for b in range(blocks)]
    real = [(s, t) for s, t in seen if t < ncols]
    assert sorted(real) == [(s, t) for s in range(slots)
                            for t in range(ncols)]
    for b in range(0, blocks, c):
        s0, t0 = seen[b]
        assert seen[b:b + c] == [(s0, t0 + r) for r in range(c)]
        assert t0 % c == 0


def _walk(a: torch.Tensor, w: torch.Tensor, off: list[int],
          plan: me.Plan) -> torch.Tensor:
    """A torch model of the kernel: every slot of the grid, its tile's
    rows times its expert over each K range in split order (fp64)."""
    n, k = a.shape
    out = torch.zeros(n, w.shape[2], dtype=torch.float64)
    ranges = (me.split_ranges(k, plan.tiles.splits)
              if plan.tiles.shape == "narrow" else [(0, k)])
    for s in range(plan.grid[0]):
        tile = me.tile_of(off, s, plan.tiles.rows)
        if tile is None:
            continue
        g, row0, rows = tile
        for k0, k1 in ranges:
            out[row0:row0 + rows] += (a[row0:row0 + rows, k0:k1].double()
                                      @ w[g, k0:k1].double())
    return out


@pytest.mark.parametrize("shape", ["narrow", "wide"])
@pytest.mark.parametrize("n,e,kind", [(20, 5, "past"), (70, 3, "random"),
                                      (1, 4, "random"), (300, 2, "one")])
def test_a_model_of_the_walk_matches_the_plain_version(n, e, kind, shape):
    rng = np.random.RandomState(n)
    k, nout = 300, 24
    off = _offsets(rng, n, e, kind)
    a = torch.from_numpy(rng.randn(n, k).astype(np.float32))
    w = torch.from_numpy(rng.randn(e, k, nout).astype(np.float32))
    tiles = (me.TcTiles("narrow", me.NARROW_ROWS, me.NARROW_COLS, 3)
             if shape == "narrow" else me.tc_tiles(10 ** 6, 1, k, nout))
    plan = me.plan(n, e, k, nout, "tc", tiles)
    got = _walk(a, w, off, plan)
    want = me.grouped_mm_plain(a, w, torch.tensor(off, dtype=torch.int32))
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    assert ((got.float() - want).abs() / scale).max() <= 1e-5
    assert not got[off[-1]:].any()


def test_a_tc_shape_the_kernel_does_not_have_is_refused():
    a = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 32, dtype=torch.bfloat16)
    off = torch.tensor([0, 1, 4], dtype=torch.int32)
    wide = me.plan(4, 2, 64, 32, "tc", me.TcTiles(
        "wide", me.WIDE_ROWS, me.WIDE_COLS, 1))
    assert me.launch(a, w, off, wide).shape == (4, 32)
    for bad in (me.TcTiles("narrow", 8, 64, 1),
                me.TcTiles("narrow", me.NARROW_ROWS, me.NARROW_COLS, 2),
                me.TcTiles("wide", me.WIDE_ROWS, me.WIDE_COLS, 2),
                me.TcTiles("square", 64, 64, 1)):
        with pytest.raises(ValueError, match="no tc shape"):
            me.plan(4, 2, 64, 32, "tc", bad)
    # a plan of other operands, and a tc plan on the fma route
    with pytest.raises(ValueError, match="not a plan"):
        me.launch(torch.zeros(300, 64, dtype=torch.bfloat16), w,
                  torch.tensor([0, 100, 300], dtype=torch.int32), wide)
    with pytest.raises(ValueError, match="fma route"):
        me.launch(a.float(), w.float(), off, wide)
