"""The split-KV design of ``paged_mla``'s kernel, held to the JAX package
on the CPU.

  * ``paged_mla``'s route rule (``kernels/paged_attention.mla_route``):
    a pure function of the widths and the pool's type; deepseek-v3's
    widths take the tensor-core route with a bf16 pool, the smoke widths
    and fp32 pools the FMA route;
  * a torch model of the CUDA kernel's split-and-merge
    (``csrc/paged_mla.cu``): the splits of ``split_bounds``, each with
    its own max m_s, sum l_s and unnormalised acc_s, merged in split
    order. On the tc route the fp32 operands (the query and p) are split
    into a high and a low TF32 part, each rounded as ``cvt.rna.tf32``
    rounds (emulated on the fp32 bits), and each product is the sum of
    the two parts' products with the pool's values; on the fma route
    nothing is rounded. The model is held to the Pallas
    ``paged_mla_kernel`` in interpret mode and to the port's
    ``paged_mla_reference`` on numpy-seeded inputs with fp32 and bf16
    pools, a fully masked split, a length-0 row and a duplicated
    (prefix-shared) block. Tolerance: 1e-4, the kernel's own gate (the
    split TF32 products are fp32-grade: the residual after two parts is
    below 2^-21 of the operand; the sums run in other orders);
  * the model's row alone equals its row in a batch, bit for bit.

On the card, ``tests/test_torch_isolation.py`` holds the kernel itself to
its plain version (``gpu``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import paged_attention as pa

jpa = importlib.import_module("repro.kernels.paged_attention")

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kvr,rope,bs,dtype,want", [
    (512, 64, 16, torch.bfloat16, "tc"),     # deepseek-v3's widths
    (512, 64, 8, torch.bfloat16, "tc"),
    (512, 64, 64, torch.bfloat16, "tc"),
    (448, 64, 16, torch.bfloat16, "tc"),     # W = 512
    (256, 64, 32, torch.bfloat16, "tc"),
    (512, 0, 16, torch.bfloat16, "tc"),
    (512, 64, 16, torch.float32, "fma"),     # fp32 pools
    (32, 8, 8, torch.bfloat16, "fma"),       # the smoke widths
    (32, 8, 8, torch.float32, "fma"),
    (512, 128, 16, torch.bfloat16, "fma"),   # W = 640 > 576
    (480, 32, 16, torch.bfloat16, "fma"),    # kvr not a multiple of 64
    (512, 32, 16, torch.bfloat16, "fma"),    # W = 544 not a multiple of 64
    (512, 64, 128, torch.bfloat16, "fma"),   # splits of 128 positions
    (512, 64, 24, torch.bfloat16, "fma"),    # splits of 72 positions
])
def test_mla_route_rule(kvr, rope, bs, dtype, want):
    assert pa.mla_route(kvr, rope, bs, dtype) == want
    # a pure function of its arguments
    assert pa.mla_route(kvr, rope, bs, dtype) == \
        pa.mla_route(kvr, rope, bs, dtype)


def test_served_mla_widths_take_their_routes():
    """deepseek-v3 at full width (bf16 pool, block 16) on the tensor
    cores; its smoke config (kvr 32, rope 8) on the CUDA cores."""
    full = get_config("deepseek-v3-671b")
    smoke = get_smoke_config("deepseek-v3-671b")
    assert pa.mla_route(full.kv_lora_rank, full.rope_head_dim, 16,
                        torch.bfloat16) == "tc"
    for dtype in (torch.float32, torch.bfloat16):
        assert pa.mla_route(smoke.kv_lora_rank, smoke.rope_head_dim, 8,
                            dtype) == "fma"


# ---------------------------------------------------------------------------
# TF32, as cvt.rna.tf32.f32 rounds
# ---------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, on the bits: add half of the dropped ulp to the magnitude
    and clear the 13 low bits (sign-magnitude: the same for both
    signs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def test_tf32_rounding_and_the_two_part_split():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.concatenate([
        rng.randn(4096), rng.randn(4096) * 1e-3, rng.rand(4096),
        [1.0, -1.0, 0.0, 1.0 + 2 ** -11, -(1.0 + 3 * 2 ** -11)]]
    ).astype(np.float32))
    hi, lo = split_tf32(x)
    # TF32: the 13 low bits are zero
    assert not (hi.view(torch.int32) & 0x1fff).any()
    assert not (lo.view(torch.int32) & 0x1fff).any()
    # to nearest: within half a TF32 ulp (2^-11 relative)
    assert ((hi - x).abs() <= x.abs() * 2 ** -11).all()
    # ties away from zero
    assert hi[-2].item() == 1.0 + 2 ** -10
    assert hi[-1].item() == -(1.0 + 2 ** -9)
    # two parts hold the fp32 value to 2^-21 of it
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= x.abs().double() * 2 ** -21).all()
    # a bf16 value is exact in TF32
    b = torch.from_numpy(rng.randn(4096).astype(np.float32)).bfloat16().float()
    assert torch.equal(tf32(b), b)


# ---------------------------------------------------------------------------
# the split-and-merge model against JAX
# ---------------------------------------------------------------------------


def split_mla_model(q_lat, q_rope, ckv_pool, krope_pool, tables, lengths,
                    scale, *, route, live_only=True):
    """The CUDA kernel's math, in torch: each split of ``split_bounds``
    (or, with ``live_only=False``, every split of the table's width,
    fully masked ones included) computes its logits s = [q_lat | q_rope]
    . [c_kv | k_rope] * scale, its own max m_s, p = e^(s - m_s), l_s =
    sum p and acc_s = p . c_kv; then the merge in split order: m = max
    m_s, l = sum l_s e^(m_s - m), acc = sum acc_s e^(m_s - m), out = acc
    / (l or 1), fp32. On route "tc" the query and p enter their products
    as the sum of a high and a low TF32 part."""
    b, h, kvr = q_lat.shape
    _, bs, _ = ckv_pool.shape
    nb = tables.shape[1]
    chunk = pa.split_chunk(bs)
    out = torch.empty(b, h, kvr, dtype=torch.float32)

    def product(a, m):
        if route == "tc":
            hi, lo = split_tf32(a)
            return hi @ m + lo @ m
        return a @ m

    for r in range(b):
        length = min(int(lengths[r]), nb * bs)
        bounds = (pa.split_bounds(length, bs) if live_only else
                  [(s, max(s, min(s + chunk, length)))
                   for s in range(0, nb * bs, chunk)])
        q = torch.cat([q_lat[r].float(), q_rope[r].float()], -1)  # (H, W)
        parts = []
        for s0, s1 in bounds:
            if s1 <= s0:   # fully masked: the empty partial
                parts.append((torch.full((h,), NEG_INF), torch.zeros(h),
                              torch.zeros(h, kvr)))
                continue
            pos = torch.arange(s0, s1)
            blk, off = tables[r, pos // bs].long(), pos % bs
            c = ckv_pool[blk, off].float()                      # (n, kvr)
            k = torch.cat([c, krope_pool[blk, off].float()], -1)
            s = product(q, k.T) * scale
            m = s.max(-1).values
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(-1), product(p, c)))
        m = torch.full((h,), NEG_INF)
        for m_s, _, _ in parts:
            m = torch.maximum(m, m_s)
        l_sum = torch.zeros(h)
        acc = torch.zeros(h, kvr)
        for m_s, l_s, acc_s in parts:
            w = torch.exp(m_s - m)
            l_sum = l_sum + l_s * w
            acc = acc + acc_s * w[:, None]
        l_sum = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
        out[r] = acc / l_sum[:, None]
    return out


def _mla_problem(seed, *, h=16, kvr=64, rope=64, bs=8, nb=12):
    """Lengths 0 (no split), 5 (one partial split; the next one fully
    masked), 64 (one whole split), 70 and 96 (two splits) at bs 8
    (splits of 64), 12 blocks a row; row 3 shares a block; a
    scratch-padded tail past each length. q_lat fp32 at the model's
    scale (~N(0, 1/kvr)), the rest N(0, 1)."""
    rng = np.random.RandomState(seed)
    lengths = np.array([0, 5, 64, 70, 96], np.int32)
    b = len(lengths)
    p = b * nb + 1
    tables = rng.randint(1, p, size=(b, nb)).astype(np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0
    tables[3, 2] = tables[3, 1]
    q_lat = (rng.randn(b, h, kvr) / np.sqrt(kvr)).astype(np.float32)
    q_rope, ckv, krope = (rng.randn(*shape).astype(np.float32) for shape in
                          ((b, h, rope), (p, bs, kvr), (p, bs, rope)))
    scale = (rope + 128) ** -0.5
    return q_lat, q_rope, ckv, krope, tables, lengths, scale


def _torch(a, dtype=None):
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _jax(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("pool,route", [("fp32", "fma"), ("bf16", "fma"),
                                        ("bf16", "tc")])
def test_split_mla_model_matches_jax_kernel_and_reference(pool, route):
    """The tc widths (kvr 64, rope 64: W 128, 16 heads a group) at both
    routes' math: 1e-4 against the Pallas kernel in interpret mode and
    the port's plain version, on the same values (a bf16 pool and q_rope
    on every side)."""
    ql, qr, ckv, kr, tables, lengths, scale = _mla_problem(3)
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if pool == "bf16"
               else (None, None))
    assert route == "fma" or pa.mla_route(
        ckv.shape[2], kr.shape[2], ckv.shape[1], dt) == route
    tq, tr, tc, tk = _torch(ql), _torch(qr, dt), _torch(ckv, dt), \
        _torch(kr, dt)
    tt, tl = _torch(tables), _torch(lengths)
    got = split_mla_model(tq, tr, tc, tk, tt, tl, scale, route=route)
    pallas = jpa.paged_mla_kernel(
        _jax(ql), _jax(qr, jdt), _jax(ckv, jdt), _jax(kr, jdt),
        _jax(tables), _jax(lengths), scale=scale, interpret=True)
    ref = pa.paged_mla_reference(tq, tr, tc, tk, tt, tl, scale=scale,
                                 compute_dtype=torch.float32)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               rtol=1e-4, atol=1e-4)
    # the length-0 row: the kernels divide a zero sum by one; the plain
    # version's softmax over all-masked logits is uniform, so it is held
    # to the rows that attend something
    assert not got[0].any()
    np.testing.assert_allclose(got[1:], ref.numpy()[1:], rtol=1e-4,
                               atol=1e-4)


def test_split_mla_model_at_deepseek_v3_widths():
    """128 heads, kvr 512, rope 64, block 16, a bf16 pool, lengths of
    deepseek-v3's decode shape: the tc model within 1e-4 of the port's
    plain version (the Pallas interpreter is too slow at this size; the
    test above ties the two)."""
    rng = np.random.RandomState(5)
    h, kvr, rope, bs, nb = 128, 512, 64, 16, 16
    lengths = np.array([256, 241, 200, 129], np.int32)
    b = len(lengths)
    p = b * nb + 1
    tables = rng.randint(1, p, size=(b, nb)).astype(np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0
    tables[1, 2] = tables[1, 1]
    ql = torch.from_numpy((rng.randn(b, h, kvr) / np.sqrt(kvr)
                           ).astype(np.float32))
    qr, ckv, kr = (torch.from_numpy(rng.randn(*s).astype(np.float32)
                                    ).bfloat16()
                   for s in ((b, h, rope), (p, bs, kvr), (p, bs, rope)))
    t, ln = torch.from_numpy(tables), torch.from_numpy(lengths)
    scale = (128 + rope) ** -0.5
    assert pa.mla_route(kvr, rope, bs, ckv.dtype) == "tc"
    got = split_mla_model(ql, qr, ckv, kr, t, ln, scale, route="tc")
    ref = pa.paged_mla_reference(ql, qr, ckv, kr, t, ln, scale=scale,
                                 compute_dtype=torch.float32)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ["fma", "tc"])
def test_fully_masked_splits_change_no_bit_of_the_merge(route):
    """Merging every split of the table's width, the fully masked ones
    (m = -1e30, l = 0, acc = 0) included, gives the bits of merging the
    row's live splits alone; the length-0 row stays 0."""
    ql, qr, ckv, kr, tables, lengths, scale = _mla_problem(4)
    args = (_torch(ql), _torch(qr, torch.bfloat16),
            _torch(ckv, torch.bfloat16), _torch(kr, torch.bfloat16),
            _torch(tables), _torch(lengths), scale)
    live = split_mla_model(*args, route=route)
    every = split_mla_model(*args, route=route, live_only=False)
    assert torch.equal(live, every)
    assert not live[0].any()


@pytest.mark.parametrize("route", ["fma", "tc"])
def test_a_row_alone_gives_its_bits_in_a_batch(route):
    """The model's row output is a function of its own q, blocks and
    length, as the kernel's is: row 3 alone, at a narrower table, equals
    row 3 of the batch bit for bit."""
    ql, qr, ckv, kr, tables, lengths, scale = _mla_problem(5)
    dt = torch.bfloat16
    pools = (_torch(ckv, dt), _torch(kr, dt))
    batch = split_mla_model(_torch(ql), _torch(qr, dt), *pools,
                            _torch(tables), _torch(lengths), scale,
                            route=route)
    alone = split_mla_model(_torch(ql[3:4]), _torch(qr[3:4], dt), *pools,
                            _torch(tables[3:4, :9].copy()),
                            _torch(lengths[3:4]), scale, route=route)
    assert torch.equal(alone[0], batch[3])


def test_the_split_partition_is_paged_gqa_s():
    """Both decode kernels split a row at the same boundaries: 64
    positions at deepseek-v3's block 16, so its decode shape (lengths
    256 / 241 / 200 / 129) has 4 + 4 + 4 + 3 = 15 live splits, and 16
    heads a block gives 15 x 128 / 16 = 120 blocks."""
    assert pa.split_chunk(16) == pa.MLA_TC_SPLIT == 64
    lives = [len(pa.split_bounds(n, 16)) for n in (256, 241, 200, 129)]
    assert lives == [4, 4, 4, 3]
    assert sum(lives) * (128 // pa.MLA_TC_HEADS) == 120
