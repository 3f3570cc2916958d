"""The partitions of the two decode-shape kernels, and the split-KV
math of paged decode, held to the JAX package on the CPU.

  * ``sidebar_matmul``'s tc partition (``kernels/sidebar_matmul.plan``):
    one panel of up to 64 rows, so each weight tile is read once at
    M <= 64; K split only under the identity epilogue; a pure function
    of its arguments;
  * ``paged_gqa``'s split rule (``kernels/paged_attention.split_bounds``):
    boundaries at multiples of ``split_chunk(bs)``, a row's splits a
    function of its own length only;
  * a torch model of the CUDA kernel's split-and-combine
    (``csrc/paged_gqa.cu``: each split's own max, p rounded to the value
    type per split, a fixed-order merge) against the Pallas
    ``paged_gqa_kernel`` in interpret mode and the port's
    ``paged_gqa_reference``, on numpy-seeded inputs with fp32, bf16 and
    int8 pools, a fully masked split, a length-0 row and a shared block.
    Tolerance: 1e-4 for fp32 and int8 pools (nothing is rounded; the
    sums run in other orders), 2e-2 for bf16 (p is rounded against the
    split's max, the Pallas body's against its running max).

On the card, ``tests/test_torch_isolation.py`` holds the kernels
themselves to their plain versions (``gpu``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sidebar_matmul as smm

jpa = importlib.import_module("repro.kernels.paged_attention")

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# sidebar_matmul: the tc partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 32, 33, 63, 64])
@pytest.mark.parametrize("k,n", [(6144, 24576), (24576, 6144), (100, 136)])
def test_matmul_tc_partition_is_one_panel_up_to_64_rows(m, k, n):
    """At M <= 64 one panel holds every row, so the grid reads each
    weight tile from HBM once; its rows are the N of an m64nN product."""
    for identity in (True, False):
        p = smm.plan(m, k, n, identity, "tc")
        assert p.route == "tc" and p.panels == 1
        assert p.panel_rows in (8, 16, 32, 64) and p.panel_rows >= m
        assert p.panel_rows == smm.tc_panel_rows(m)
        assert p.tiles == -(-n // smm.TC_BLOCK_N)


@pytest.mark.parametrize("m,panels", [(65, 2), (128, 2), (130, 3),
                                      (4096, 64)])
def test_matmul_tc_partition_walks_panels_of_64_above_64_rows(m, panels):
    p = smm.plan(m, 6144, 256, True, "tc")
    assert (p.panel_rows, p.panels) == (64, panels)


@pytest.mark.parametrize("m,k,n,splits", [
    (4, 6144, 24576, 2),      # the producer at decode: 384 tiles
    (4, 24576, 6144, 8),      # the consumer at decode: 96 tiles
    (64, 6144, 24576, 2),
    (64, 24576, 6144, 8),
    (3, 100, 136, 1),         # one chunk: nothing to split
])
def test_matmul_tc_splits_k_only_under_the_identity(m, k, n, splits):
    ident = smm.plan(m, k, n, True, "tc")
    other = smm.plan(m, k, n, False, "tc")
    assert ident.splits == splits
    assert other.splits == 1 and other.k_range >= k
    for p in (ident, other):
        # whole 128-deep chunks; the splits cover K, none of them empty
        assert p.k_range % smm.TC_BLOCK_K == 0
        assert (p.splits - 1) * p.k_range < k <= p.splits * p.k_range


@pytest.mark.parametrize("m,k,n", [(4, 6144, 24576), (64, 24576, 6144),
                                   (17, 513, 264), (200, 1000, 8)])
@pytest.mark.parametrize("route", ["tc", "fma"])
def test_matmul_plan_is_a_pure_function_of_its_arguments(m, k, n, route):
    for identity in (True, False):
        a = smm.plan(m, k, n, identity, route)
        assert a == smm.plan(m, k, n, identity, route)
        if route == "fma":
            assert a.k_range == smm.k_range(m, k, n, identity)
            assert a.panel_rows == smm.BLOCK_M


@pytest.mark.parametrize("shape_a,shape_b,dtype,want", [
    ((4, 6144), (6144, 24576), torch.bfloat16, "tc"),
    ((64, 24576), (24576, 6144), torch.bfloat16, "tc"),
    ((4, 100), (100, 260), torch.bfloat16, "fma"),   # K not a multiple of 8
    ((4, 64), (64, 130), torch.bfloat16, "fma"),     # N not a multiple of 8
    ((4, 64), (64, 128), torch.float32, "fma"),
    ((4, 0), (0, 128), torch.bfloat16, "fma"),       # no contraction
])
def test_matmul_operand_route(shape_a, shape_b, dtype, want):
    a, b = torch.zeros(shape_a, dtype=dtype), torch.zeros(shape_b,
                                                          dtype=dtype)
    assert smm.operand_route(a, b) == want


# ---------------------------------------------------------------------------
# paged_gqa: the split rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs,chunk", [(8, 64), (16, 64), (32, 64),
                                      (64, 64), (128, 128), (24, 72)])
def test_split_chunk_is_whole_blocks(bs, chunk):
    assert pa.split_chunk(bs) == chunk and chunk % bs == 0


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 129, 241, 256])
def test_split_bounds_sit_at_multiples_of_the_chunk(bs, length):
    c = pa.split_chunk(bs)
    bounds = pa.split_bounds(length, bs)
    assert len(bounds) == -(-length // c)
    for i, (s0, s1) in enumerate(bounds):
        assert s0 == i * c and s0 < s1 <= min(s0 + c, length)
    assert [p for s0, s1 in bounds for p in range(s0, s1)] == \
        list(range(length))


def test_split_count_depends_on_the_length_only():
    """Each row of a batch gets the splits it gets alone, whatever its
    batch mates and the table width."""
    for bs in (8, 16):
        alone = {ln: pa.split_bounds(ln, bs) for ln in (0, 5, 64, 70, 200)}
        batch = [5, 200, 0, 70, 64]
        for nb in (-(-200 // bs), 64):
            assert nb * bs >= 200
            assert [pa.split_bounds(ln, bs) for ln in batch] == \
                [alone[ln] for ln in batch]


# ---------------------------------------------------------------------------
# paged_gqa: the split-and-combine math against JAX
# ---------------------------------------------------------------------------


def split_kv_model(q, k_pool, v_pool, tables, lengths, scale, k_scale=None,
                   v_scale=None, *, live_only=True):
    """The CUDA kernel's math, in torch: each split of
    ``split_bounds`` (or, with ``live_only=False``, every split of the
    table's width, fully masked ones included) computes its logits, its
    own max m_s, p = e^(s - m_s), l_s = sum p and acc_s = round(p) . V
    (p rounded to the pool's type for a bf16 pool; fp32 otherwise);
    then the merge in split order: m = max m_s, l = sum l_s e^(m_s - m),
    acc = sum acc_s e^(m_s - m), out = acc / (l or 1) in q's type."""
    b, h, dh = q.shape
    _, hkv, bs, _ = k_pool.shape
    group, nb = h // hkv, tables.shape[1]
    chunk = pa.split_chunk(bs)
    rounds = k_pool.dtype == torch.bfloat16
    out = torch.empty(b, h, dh, dtype=q.dtype)
    for r in range(b):
        length = min(int(lengths[r]), nb * bs)
        bounds = (pa.split_bounds(length, bs) if live_only else
                  [(s, max(s, min(s + chunk, length)))
                   for s in range(0, nb * bs, chunk)])
        for hk in range(hkv):
            qg = q[r, hk * group:(hk + 1) * group].float()
            parts = []
            for s0, s1 in bounds:
                if s1 <= s0:   # fully masked: the empty partial
                    parts.append((torch.full((group,), NEG_INF),
                                  torch.zeros(group),
                                  torch.zeros(group, dh)))
                    continue
                pos = torch.arange(s0, s1)
                blk, off = tables[r, pos // bs].long(), pos % bs
                kk = k_pool[blk, hk, off].float()
                vv = v_pool[blk, hk, off].float()
                if k_scale is not None:
                    kk = kk * k_scale[blk, hk, off][:, None]
                    vv = vv * v_scale[blk, hk, off][:, None]
                s = (qg @ kk.T) * scale
                m = s.max(-1).values
                p = torch.exp(s - m[:, None])
                pr = p.bfloat16().float() if rounds else p
                parts.append((m, p.sum(-1), pr @ vv))
            m = torch.full((group,), NEG_INF)
            for m_s, _, _ in parts:
                m = torch.maximum(m, m_s)
            l_sum = torch.zeros(group)
            acc = torch.zeros(group, dh)
            for m_s, l_s, acc_s in parts:
                w = torch.exp(m_s - m)
                l_sum = l_sum + l_s * w
                acc = acc + acc_s * w[:, None]
            l_sum = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
            out[r, hk * group:(hk + 1) * group] = (
                acc / l_sum[:, None]).to(q.dtype)
    return out


def _split_problem(seed, *, group, pool):
    """Lengths 0 (no split), 5 (one partial split; the next one fully
    masked), 64 (one whole split), 70 and 96 (two splits) at bs 8
    (chunk 64), 12 blocks a row; row 3 shares a block; a scratch-padded
    tail past each length."""
    rng = np.random.RandomState(seed)
    hkv, bs, dh, nb = 2, 8, 16, 12
    lengths = np.array([0, 5, 64, 70, 96], np.int32)
    b = len(lengths)
    p = b * nb + 1
    tables = rng.randint(1, p, size=(b, nb)).astype(np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0
    tables[3, 2] = tables[3, 1]
    q = rng.randn(b, hkv * group, dh).astype(np.float32)
    ks = vs = None
    if pool == "int8":
        k, v = (rng.randint(-127, 128, (p, hkv, bs, dh)).astype(np.int8)
                for _ in range(2))
        ks, vs = (((rng.rand(p, hkv, bs) + .5) / 127).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.randn(p, hkv, bs, dh).astype(np.float32)
                for _ in range(2))
    return q, k, v, ks, vs, tables, lengths, dh ** -0.5


def _torch(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _jax(a, dtype=None):
    if a is None:
        return None
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("group", [4, 1])
@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
def test_split_kv_model_matches_jax_kernel_and_reference(pool, group):
    q, k, v, ks, vs, tables, lengths, scale = _split_problem(
        11 + group, group=group, pool=pool)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if pool == "bf16"
                else (None, None))
    tq, tk, tv = _torch(q, tdt), _torch(k, tdt), _torch(v, tdt)
    kw = dict(k_scale=_torch(ks), v_scale=_torch(vs))
    got = split_kv_model(tq, tk, tv, _torch(tables), _torch(lengths), scale,
                         **kw)
    pallas = jpa.paged_gqa_kernel(
        _jax(q, jdt), _jax(k, jdt), _jax(v, jdt), _jax(tables),
        _jax(lengths), scale=scale, k_scale=_jax(ks), v_scale=_jax(vs),
        interpret=True)
    ref = pa.paged_gqa_reference(tq, tk, tv, _torch(tables),
                                 _torch(lengths), scale=scale, **kw)
    tol = 2e-2 if pool == "bf16" else 1e-4
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               rtol=tol, atol=tol)
    # the length-0 row: the kernels divide a zero sum by one; the plain
    # version's softmax over all-masked logits is uniform, so it is held
    # to the rows that attend something
    assert not got[0].any()
    np.testing.assert_allclose(got[1:], ref.float().numpy()[1:], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
def test_fully_masked_splits_change_no_bit_of_the_merge(pool):
    """Merging every split of the table's width, the fully masked ones
    (m = -1e30, l = 0, acc = 0) included, gives the bits of merging the
    row's live splits alone: e^(m_s - m) is 0 for them beside a live
    split, and 1 only where every split is masked (the length-0 row),
    where l = acc = 0 keeps the output 0."""
    q, k, v, ks, vs, tables, lengths, scale = _split_problem(
        21, group=4, pool=pool)
    dt = torch.bfloat16 if pool == "bf16" else None
    args = (_torch(q, dt), _torch(k, dt), _torch(v, dt), _torch(tables),
            _torch(lengths), scale, _torch(ks), _torch(vs))
    live = split_kv_model(*args)
    every = split_kv_model(*args, live_only=False)
    assert torch.equal(live, every)
    assert not live[0].any()


def test_a_row_alone_gives_its_bits_in_a_batch():
    """The model's row output is a function of its own q, blocks and
    length, as the kernel's is: row 3 alone, at a narrower table, equals
    row 3 of the batch bit for bit."""
    q, k, v, _, _, tables, lengths, scale = _split_problem(
        31, group=4, pool="fp32")
    batch = split_kv_model(_torch(q), _torch(k), _torch(v), _torch(tables),
                           _torch(lengths), scale)
    alone = split_kv_model(_torch(q[3:4]), _torch(k), _torch(v),
                           _torch(tables[3:4, :9].copy()),
                           _torch(lengths[3:4]), scale)
    assert torch.equal(alone[0], batch[3])
