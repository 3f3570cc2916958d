"""Plain PyTorch versions (mirror of ``repro.kernels.ref``) and the
contraction/softmax helpers every plain path of the port uses.

On a CPU tensor the helpers accumulate in a FIXED order, one term at a
time from index 0 up (``dot``, ``softmax``). A row's result then depends
only on that row's operands — not on how many rows share the call, nor
on how many masked (exactly zero) terms trail the live ones. That is
what keeps the port's in-framework gates bit-exact on the CPU (paged
== slab == solo decode), as XLA's CPU dot does for the JAX package;
torch's blocked CPU GEMM gives no such guarantee. On a CUDA tensor they
are plain ``torch.matmul``/``torch.sum`` calls with fp32 accumulation.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable

Tensor = torch.Tensor

NEG_INF = -1e30


def dot(a: Tensor, b: Tensor, out_dtype: torch.dtype = torch.float32
        ) -> Tensor:
    """``a (..., M, K) @ b (..., K, N)`` accumulated in fp32, cast to
    ``out_dtype`` (``preferred_element_type`` of the jnp dot)."""
    if a.is_cuda:
        if a.dtype == b.dtype == out_dtype:
            return torch.matmul(a, b)
        return torch.matmul(a.float(), b.float()).to(out_dtype)
    af, bf = a.float(), b.float()
    acc = af[..., :, 0:1] * bf[..., 0:1, :]
    for k in range(1, af.shape[-1]):
        acc = acc + af[..., :, k:k + 1] * bf[..., k:k + 1, :]
    return acc.to(out_dtype)


def row_sum(x: Tensor) -> Tensor:
    """Sum over the last dim, keepdim (fixed order on the CPU)."""
    if x.is_cuda:
        return x.sum(-1, keepdim=True)
    acc = x[..., 0:1]
    for t in range(1, x.shape[-1]):
        acc = acc + x[..., t:t + 1]
    return acc


def softmax(x: Tensor) -> Tensor:
    """``jax.nn.softmax`` over the last dim: exp(x - max) / sum."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / row_sum(e)


def rowwise_pos(pos) -> bool:
    """True when ``cache_pos`` is a per-row ``(B,)`` vector."""
    return isinstance(pos, Tensor) and pos.ndim == 1


def attend_direct_offset(q: Tensor, k: Tensor, v: Tensor, group: int,
                         scale: float, causal: bool, offset) -> Tensor:
    """q (B, H, S, Dh) against k/v (B, Hkv, T, Dh); ``offset`` is the
    global position of query row 0, scalar or per-row (B,). Masked
    logits are -1e30, which underflow to exactly 0.0 in fp32."""
    b, h, s, dh = q.shape
    t = k.shape[2]
    qg = q.reshape(b, k.shape[1], group, s, dh)
    logits = dot(qg, k.unsqueeze(2).transpose(-1, -2)) * scale
    if causal:
        kpos = torch.arange(t, device=q.device)
        if rowwise_pos(offset):
            qpos = (torch.arange(s, device=q.device)[None, :]
                    + offset.to(q.device)[:, None])              # (B, s)
            mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None, None]
        else:
            qpos = torch.arange(s, device=q.device)[:, None] + offset
            mask = kpos[None, :] <= qpos
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, device=q.device))
    p = softmax(logits)
    out = dot(p.to(v.dtype), v.unsqueeze(2))
    return out.reshape(b, h, s, v.shape[-1]).to(q.dtype)


def attend_mla_absorbed(q_lat: Tensor, q_rope: Tensor, c_kv: Tensor,
                        k_rope: Tensor, end, scale: float) -> Tensor:
    """MLA absorbed decode on a dense view (mirror of the absorbed branch
    of ``repro.models.attention.mla_attention``): q_lat (B, H, kvr)
    fp32 and q_rope (B, H, rope) against c_kv (B, T, kvr) and k_rope
    (B, T, rope); ``end`` is the last visible position, scalar or per
    row (B,). Logits = (q_lat . c_kv + q_rope . k_rope) * scale in fp32,
    -1e30 at positions past ``end``, softmax, ctx = p . c_kv. Returns
    ctx_lat (B, H, kvr) fp32."""
    ckv = c_kv.float()
    logits = (dot(q_lat.float(), ckv.transpose(-1, -2))
              + dot(q_rope.float(), k_rope.float().transpose(-1, -2))
              ) * scale                                       # (B, H, T)
    t = ckv.shape[1]
    kpos = torch.arange(t, device=q_lat.device)
    if rowwise_pos(end):
        mask = kpos[None, None, :] <= end.to(q_lat.device)[:, None, None]
    else:
        mask = kpos <= int(end)
    logits = torch.where(mask, logits,
                         torch.full((), NEG_INF, device=q_lat.device))
    return dot(softmax(logits), ckv)


def _resolve(activation: str | Callable, table: FunctionTable) -> Callable:
    if callable(activation):
        return activation
    return table.lookup(activation)


def sidebar_mlp_ref(
    x: Tensor,
    w1: Tensor,
    w2: Tensor,
    activation: str | Callable = "relu",
    table: FunctionTable = DEFAULT_TABLE,
) -> Tensor:
    """y = f(x @ w1) @ w2: fp32 ``h``, ``f`` in fp32, ``f(h)`` cast to
    ``w2.dtype`` before the second product, fp32 accumulation, output in
    ``x.dtype`` — the rounding points of ``repro.kernels.ref``."""
    fn = _resolve(activation, table)
    h = fn(dot(x, w1))
    y = dot(h.to(w2.dtype), w2)
    return y.to(x.dtype)


def sidebar_gated_mlp_ref(
    x: Tensor,
    w_gate: Tensor,
    w_up: Tensor,
    w_down: Tensor,
    activation: str | Callable = "silu",
    table: FunctionTable = DEFAULT_TABLE,
) -> Tensor:
    """y = (f(x @ w_gate) * (x @ w_up)) @ w_down: fp32 gate and up,
    ``f`` in fp32, their product cast to ``w_down.dtype`` before the
    third product, fp32 accumulation, output in ``x.dtype``."""
    fn = _resolve(activation, table)
    g = fn(dot(x, w_gate))
    u = dot(x, w_up)
    y = dot((g * u).to(w_down.dtype), w_down)
    return y.to(x.dtype)


def sidebar_matmul_ref(
    a: Tensor,
    b: Tensor,
    activation: str | Callable = "identity",
    table: FunctionTable = DEFAULT_TABLE,
) -> Tensor:
    """c = f(a @ b): fp32 product, ``f`` on the fp32 result, cast to
    ``a.dtype`` — one static primitive with a function-table epilogue."""
    fn = _resolve(activation, table)
    return fn(dot(a, b)).to(a.dtype)


def activation_ref(
    x: Tensor,
    activation: str | Callable = "relu",
    table: FunctionTable = DEFAULT_TABLE,
) -> Tensor:
    """Standalone host activation (the FLEXIBLE_DMA 'host step')."""
    fn = _resolve(activation, table)
    return fn(x.float()).to(x.dtype)
