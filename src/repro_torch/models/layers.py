"""Shared building blocks (mirror of ``repro.models.layers``): norms,
rope, linears, embeddings and the seeded initializer.

Parameters are plain dicts of tensors. ``init_leaf`` draws one with the
scales of the JAX package's ``materialize`` (``1/sqrt(fan_in)`` for
matrices, fan-in the second-to-last axis, 0.02 for the embedding, ones
for norms) from a ``torch.Generator``; the numbers differ from
``jax.random``'s, so tests that compare the two load JAX's weights
through ``repro_torch.bridge``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import dot

Tensor = torch.Tensor


def init_leaf(shape: tuple[int, ...], init: str, dtype: torch.dtype, *,
              generator: torch.Generator, device: torch.device) -> Tensor:
    """One parameter with its declared initializer (``materialize``)."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    std = 0.02 if init == "embed" else 1.0 / math.sqrt(
        shape[-2] if len(shape) >= 2 else max(shape[-1], 1))
    if len(shape) >= 3:
        # a stack with a leading (expert) axis: one slice at a time into
        # the target dtype, so the fp32 draw never holds the whole stack
        # (a 7.5 GB bf16 expert stack would need 30 GB of fp32 at once)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            w = torch.randn(shape[1:], generator=generator,
                            dtype=torch.float32, device=device)
            out[i] = (w * std).to(dtype)
        return out
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0
               ) -> Tensor:
    """Rotary embedding. x: (..., S, H, Dh) or (..., S, Dh); positions
    (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., None].float() * freqs
    if x.ndim == angles.ndim + 1:                      # head dim present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def linear(x: Tensor, w: Tensor) -> Tensor:
    """x (..., D) @ w (D, F): bf16 in -> bf16 out (fp32 accumulation
    inside), fp32 in -> fp32 accumulation and out."""
    return dot(x, w, torch.float32 if x.dtype == torch.float32 else x.dtype)


VOCAB_PAD = 16


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def embed_lookup(table: Tensor, tokens: Tensor) -> Tensor:
    return table[tokens]


def unembed(x: Tensor, table: Tensor) -> Tensor:
    """Logits = x @ E^T (tied), fp32 out, width = padded vocab. bf16
    operands on the card go through one GEMM with an fp32 output: the
    256000 x 6144 table is never copied to fp32."""
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x.reshape(-1, x.shape[-1]), table.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], table.shape[0])
    return dot(x, table.t())


def mask_pad_logits(logits: Tensor, vocab: int) -> Tensor:
    """-1e30 on the padded vocab columns."""
    if logits.shape[-1] == vocab:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < vocab, logits,
                       torch.full((), -1e30, device=logits.device))
