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

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels.ref import dot
from repro_torch.parallel import tp

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Which mesh axes exist, how they are used, and how big they are
    (``repro.models.layers.MeshInfo``)."""

    axis_names: tuple[str, ...]
    fsdp: tuple[str, ...]   # parameter sharding axes ("pod", "data")
    tp: str = "model"       # tensor-parallel axis
    sizes: tuple[tuple[str, int], ...] = ()

    @classmethod
    def from_axes(cls, axis_names: tuple[str, ...],
                  sizes: dict[str, int] | None = None) -> "MeshInfo":
        fsdp = tuple(a for a in ("pod", "data") if a in axis_names)
        return cls(tuple(axis_names), fsdp,
                   sizes=tuple(sorted((sizes or {}).items())))

    def size(self, axes) -> int:
        """Product of the sizes of ``axes`` (1 for unknown axes)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        m = dict(self.sizes)
        n = 1
        for a in axes:
            n *= m.get(a, 1)
        return n


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


def materialize(shapes, dtype: torch.dtype, *, seed: int,
                device: torch.device):
    """Draw every leaf of a shape tree (dicts and lists of ``(shape,
    init)``, or ``(shape, init, leaf_dtype)`` for a leaf the JAX package
    keeps in its own type) from one seeded ``torch.Generator``, in tree
    order."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(tree):
        if isinstance(tree, list):
            return [build(t) for t in tree]
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        shape, init, *leaf_dtype = tree
        return init_leaf(shape, init, leaf_dtype[0] if leaf_dtype else dtype,
                         generator=gen, device=device)

    return build(shapes)


def zeros(shapes, device: torch.device):
    """Zero tensors for a tree of ``(shape, dtype)`` leaves (caches and
    recurrent states)."""
    if isinstance(shapes, list):
        return [zeros(t, device) for t in shapes]
    if isinstance(shapes, dict):
        return {k: zeros(v, device) for k, v in shapes.items()}
    shape, dtype = shapes
    return torch.zeros(shape, dtype=dtype, device=device)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT = ("full", "dots", "none")


def remat_kwargs(cfg) -> dict | None:
    """``torch.utils.checkpoint`` arguments for ``cfg.remat`` when the
    forward is differentiated; None when every activation is kept.
    "full" recomputes a checkpointed layer's activations in the
    backward; "dots" saves the outputs of its un-batched matrix products
    (``aten.mm``; the JAX policy ``checkpoint_dots_with_no_batch_dims``)
    and recomputes the rest."""
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return None
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return kw


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


def embed_lookup(table: Tensor, tokens: Tensor, *,
                 sharded: bool = False) -> Tensor:
    """Embedding lookup. Sharded (under the ambient TP context) the local
    table holds vocab rows [offset, offset + V_local): ids are rebased,
    off-shard ids take zero rows, and the fp32 partials are summed over
    the model axis BEFORE the cast — exact zeros plus one exact row, so
    the lookup equals the unsharded one bit for bit at any shard
    count."""
    if not sharded:
        return table[tokens]
    n = table.shape[0]
    ids = tokens - tp.shard_offset(n)
    inside = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)].float()
    out = torch.where(inside[..., None], rows, 0.0)
    return tp.psum_partial(out).to(table.dtype)


class _UnembedMM(torch.autograd.Function):
    """x2 (N, D) @ table (V, D)^T with an fp32 output from bf16 operands
    (``torch.mm(..., out_dtype=float32)``), and its gradient: the
    logits' fp32 cotangent rounded to the operands' type, then the two
    products of the backward in that type (fp32 accumulation inside). No
    fp32 copy of the table (6.3 GB at nemotron-4-15b's width) is made on
    either pass."""

    @staticmethod
    def forward(ctx, x2: Tensor, table: Tensor) -> Tensor:
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: Tensor):
        x2, table = ctx.saved_tensors
        g = g.to(table.dtype)
        gx = torch.mm(g, table) if ctx.needs_input_grad[0] else None
        gt = torch.mm(g.t(), x2) if ctx.needs_input_grad[1] else None
        return gx, gt


def unembed(x: Tensor, table: Tensor) -> Tensor:
    """Logits = x @ E^T (tied), fp32 out, width = padded vocab. bf16
    operands on the card go through one GEMM with an fp32 output (and
    its two GEMMs under autograd): the 256000 x 6144 table is never
    copied to fp32. Under the ambient TP context the table is a vocab
    shard, so the local product is a column slice of the logits (exact
    per column: d is never split), gathered to full width once."""
    if x.is_cuda and x.dtype != torch.float32:
        out = _UnembedMM.apply(x.reshape(-1, x.shape[-1]), table)
        out = out.reshape(*x.shape[:-1], table.shape[0])
    else:
        out = dot(x, table.t())
    return tp.all_gather_cols(out)


def mask_pad_logits(logits: Tensor, vocab: int) -> Tensor:
    """-1e30 on the padded vocab columns."""
    if logits.shape[-1] == vocab:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < vocab, logits,
                       torch.full((), -1e30, device=logits.device))


def softmax_cross_entropy(logits: Tensor, labels: Tensor,
                          vocab: int | None = None) -> Tensor:
    """Mean token NLL; logits (T, V_pad) taken in fp32, labels int (T,);
    ``vocab`` masks the padded columns first."""
    logits = logits.float()
    if vocab is not None:
        logits = mask_pad_logits(logits, vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
