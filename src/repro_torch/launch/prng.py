"""The parts of ``jax.random`` that sampling uses, in torch integer ops.

The serving paths key every sampled token by (request key, position)
(``launch.sampling``); reproducing the JAX package's streams needs its
PRNG bit for bit:

  * ``prng_key(seed)`` — ``jax.random.PRNGKey`` of the default threefry
    implementation with 64-bit types off: the key words ``(0, seed mod
    2^32)``;
  * ``fold_in(key, data)`` — threefry-2x32 of the key over the counter
    pair ``(0, data)``;
  * ``random_bits(key, shape)`` — 32-bit random bits in the
    *partitionable* layout (``jax_threefry_partitionable``, the default
    since jax 0.5): element ``i`` of the flattened shape hashes the
    counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and its bits are the XOR
    of the two output words;
  * ``uniform``, ``gumbel`` (the default, low-range mode) and
    ``categorical`` with replacement (``argmax(gumbel + logits)``).

A key is a pair of 32-bit words held in an int64 tensor of shape
``(..., 2)``; leading axes batch independent keys (``jax.vmap`` of the
JAX functions). All arithmetic is int64 masked to 32 bits, which gives
exact uint32 wraparound and logical right shifts (torch's ``uint32``
supports too few ops, and ``>>`` on int32 is arithmetic). Every op is a
plain tensor op on the key's device, so a sampled decode step can be
captured in a CUDA graph.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1: Tensor, x2: Tensor) -> tuple[Tensor, Tensor]:
    """The threefry-2x32 hash (20 rounds) of the counter words
    ``(x1, x2)`` under the key words ``(k1, k2)``: int64 tensors (or
    ints) holding 32-bit values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int) -> Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) int64 on the CPU."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def fold_in(key: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or a tensor
    broadcastable to the key's batch shape (taken mod 2^32, as JAX's
    uint32 conversion of an int32 does)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: Tensor, shape: tuple[int, ...]) -> Tensor:
    """32-bit random bits of ``shape`` per key (partitionable threefry):
    key (..., 2) -> int64 (..., *shape) holding uint32 values."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(*batch, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*batch, *([1] * len(shape)))
    b1, b2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & MASK).reshape(shape))
    return b1 ^ b2


def _floats01(bits: Tensor) -> Tensor:
    """[0, 1) fp32 from 32 random bits: the top 23 bits as the mantissa
    of a float in [1, 2), minus one."""
    one = 0x3F800000
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform`` in fp32: key (..., 2) -> (..., *shape)."""
    # filled on the device (no host copy: the step may be captured)
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    u = _floats01(random_bits(key, shape)) * (hi - lo) + lo
    return torch.maximum(lo, u)


def gumbel(key: Tensor, shape: tuple[int, ...]) -> Tensor:
    """``jax.random.gumbel`` (default mode) in fp32: -log(-log(u)) for
    u uniform on [tiny, 1)."""
    u = uniform(key, shape, minval=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def categorical(key: Tensor, logits: Tensor) -> Tensor:
    """``jax.random.categorical`` over the last axis, with replacement:
    key (..., 2), logits (..., V) fp32 -> (...) int64 indices."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
