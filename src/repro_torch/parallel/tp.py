"""Ambient tensor-parallel context of the serving and training steps
(mirror of ``repro.parallel.tp``).

The JAX servers run a whole serve / prefill step under one
``shard_map`` over the mesh's "model" axis. The port runs the same step
in every rank of a ``torch.distributed`` process group instead: each
rank holds its shard of the parameters and caches (``launch.serve``'s
``TpSpec``) and calls the same model functions, which read this
thread-local context to (a) reduce their row-parallel partials over the
group and (b) know which vocab rows and experts the local shard owns.

Every helper is an identity when no context is installed, so the model
code stays single-source: the same ``mlp()`` / ``attention()`` body runs
unsharded and under tensor parallelism. The context is installed even
for a group of one rank (a ``(1, 1)`` host mesh): the collective is
still issued (on the card, a captured decode step holds an NCCL
all-reduce), and a sum over one rank is an exact identity, which keeps
the host-mesh servers bit-exact against the solo server.

The transport follows the group (``TpContext.transport``): ``"nccl"``
for a group on CUDA devices, ``"gloo"`` for CPU tensors, and
``"gloo-host-staged"`` for a gloo group whose tensors live on a card
(two ranks sharing one card: NCCL refuses two ranks on one device).
Gloo lacks an all-gather of CUDA tensors, so there every helper copies
its tensor to the host, runs the collective and copies the result back,
on one route for both collectives. A CUDA graph cannot hold those
copies: a capture that reaches one raises (run under
``graphs.disable_capture()``).

Training on a mesh (``launch.train.make_jitted_train_step``; in the JAX
package GSPMD partitions the step) runs under the same context with the
rank's fsdp group ("pod" x "data") and the sharding description of the
parameters it holds (``specs``). The helpers then take part in autograd:

  * ``psum_partial``: all-reduce forward, identity backward (on a copy:
    a tensor autograd saved is never reduced in place);
  * ``copy_to_model``: identity forward, all-reduce of the gradient
    backward. Every replicated tensor that enters a "model"-sharded
    computation passes it; otherwise a replicated parameter upstream
    gets a partial gradient on each rank;
  * ``all_gather_cols``: its backward takes this rank's columns;
  * ``gather_params``: ZeRO-3. A leaf sharded over fsdp is all-gathered
    at use and its gradient reduce-scattered back to the shard; a leaf
    replicated over fsdp passes as it is and its gradient is
    all-reduced. Over a group of one both are identities.

Forward-only calls (serving, ``torch.no_grad``) take the routes above
unchanged, so the serving steps keep their bits. Gloo's reduce-scatter
is an all-reduce of which the rank keeps its block (older gloo builds
have none).

Each helper adds the bytes it moves to ``coll_bytes`` by kind
("all-reduce", "all-gather", "reduce-scatter") with the JAX package's
accounting
(``launch.roofline``): the result's bytes times ``ALGO_FACTOR`` of the
kind. A group of one rank moves nothing and counts nothing, as a size-1
collective vanishes from the reference's compiled program. A captured
graph re-adds the bytes its capture counted at every replay
(``launch.graphs``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.launch.roofline import ALGO_FACTOR

_STATE = threading.local()

TRANSPORTS = ("nccl", "gloo", "gloo-host-staged")

# collective kind -> bytes moved so far (result bytes x ALGO_FACTOR)
coll_bytes: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True, eq=False)
class TpContext:
    axis: str        # mesh axis the step is sharded over ("model")
    size: int        # ranks on that axis
    rank: int        # this rank's index on it
    group: Any       # the axis' torch.distributed process group
    transport: str   # one of TRANSPORTS
    # training on a mesh: the fsdp group ("pod" x "data": the ranks that
    # share this rank's "model" index), and the sanitized sharding
    # description of the parameters the rank holds; serving leaves them
    fsdp_size: int = 1
    fsdp_rank: int = 0
    fsdp_group: Any = None
    specs: Any = None


def active() -> TpContext | None:
    """The installed TP context, or None outside a sharded step."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def tensor_parallel(ctx: TpContext):
    """Install ``ctx`` while a step runs."""
    if ctx.transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                         f"{ctx.transport!r}")
    prev = active()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def carried(fn):
    """``fn`` run under the context active now, wherever it is called: a
    remat recompute runs in autograd's device thread (on the card),
    whose thread-local context is unset."""
    ctx = active()

    def run(*args, **kwargs):
        prev = active()
        _STATE.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _STATE.ctx = prev

    return run


def collective_bytes() -> dict[str, float]:
    """Bytes counted per kind since the last ``reset_coll_bytes``."""
    return {k: float(coll_bytes[k]) for k in ALGO_FACTOR}


def reset_coll_bytes() -> None:
    coll_bytes.clear()


def _count(size: int, kind: str, result: torch.Tensor) -> None:
    if size > 1:
        coll_bytes[kind] += (result.numel() * result.element_size()
                             * ALGO_FACTOR[kind])


def _staged(transport: str, x: torch.Tensor) -> bool:
    """Whether this collective goes through host memory (gloo with a
    tensor on the card); raises inside a CUDA graph capture."""
    if transport != "gloo-host-staged":
        return False
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a gloo group stages its collectives through host memory, "
            "which a CUDA graph cannot hold: run the servers of this "
            "mesh under graphs.disable_capture()")
    return x.is_cuda


def _reduce_(x: torch.Tensor, group, transport: str,
             op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce contiguous ``x`` in place over ``group``."""
    if _staged(transport, x):
        host = x.cpu()
        dist.all_reduce(host, op=op, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def _gather(x: torch.Tensor, group, size: int, transport: str,
            dim: int) -> torch.Tensor:
    """The ``size`` ranks' blocks of ``group`` concatenated along
    ``dim`` (tiled), in rank order."""
    x = x.contiguous()
    if transport == "nccl":
        out = torch.empty((size, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        parts = out.unbind(0)
    else:
        staged = _staged(transport, x)
        src = x.cpu() if staged else x
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        if staged:
            parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim=dim)


def _scatter_sum(x: torch.Tensor, group, size: int, rank: int,
                 transport: str, dim: int) -> torch.Tensor:
    """Reduce-scatter: the sum over ``group`` of ``x``, of which this
    rank keeps block ``rank`` along ``dim``."""
    n = x.shape[dim] // size
    if transport == "nccl":
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((n, *xm.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, xm, group=group)
        return out.movedim(0, dim)
    full = _reduce_(x.contiguous().clone(), group, transport)
    return full.narrow(dim, rank * n, n).clone()


def gather_along(x: torch.Tensor, group, size: int, transport: str,
                 dim: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group`` (no autograd:
    checkpoints and the placement's gathers), counted."""
    if size == 1:
        return x
    out = _gather(x, group, size, transport, dim)
    _count(size, "all-gather", out)
    return out


def _fsdp(ctx: TpContext) -> tuple:
    return ctx.fsdp_group, ctx.fsdp_size, ctx.fsdp_rank, ctx.transport


def _model(ctx: TpContext) -> tuple:
    return ctx.group, ctx.size, ctx.rank, ctx.transport


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _PsumPartial(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        out = _reduce_(x.contiguous().clone(), ctx.group, ctx.transport)
        _count(ctx.size, "all-reduce", out)
        return out

    @staticmethod
    def backward(fctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.tp = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.tp
        g = _reduce_(g.contiguous().clone(), ctx.group, ctx.transport)
        _count(ctx.size, "all-reduce", g)
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over one axis forward; backward: the
    reduce-scatter of the gradient (``reduce=True``) or this rank's
    block of it (the gathered tensor's other blocks got no gradient
    here: the logits' columns, the rows of the other data shards)."""

    @staticmethod
    def forward(fctx, x, axis, dim, reduce):
        group, size, rank, transport = axis
        fctx.axis, fctx.dim, fctx.reduce = axis, dim, reduce
        out = _gather(x, group, size, transport, dim)
        _count(size, "all-gather", out)
        return out

    @staticmethod
    def backward(fctx, g):
        group, size, rank, transport = fctx.axis
        if fctx.reduce:
            out = _scatter_sum(g, group, size, rank, transport, fctx.dim)
            _count(size, "reduce-scatter", out)
        else:
            n = g.shape[fctx.dim] // size
            out = g.narrow(fctx.dim, rank * n, n)
        return out, None, None, None


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over one axis."""

    @staticmethod
    def forward(fctx, x, axis):
        fctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        group, size, _, transport = fctx.axis
        g = _reduce_(g.contiguous().clone(), group, transport)
        _count(size, "all-reduce", g)
        return g, None


def psum_partial(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel partial over the model axis (identity when no
    TP context is active). Forward-only, it reduces ``x`` in place when
    it is contiguous: every caller passes a fresh partial. Under
    autograd it reduces a copy and its backward is the identity."""
    ctx = active()
    if ctx is None:
        return x
    if _tracked(x):
        return _PsumPartial.apply(x, ctx)
    x = x.contiguous()
    _reduce_(x, ctx.group, ctx.transport)
    _count(ctx.size, "all-reduce", x)
    return x


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; under autograd its backward sums the gradient over the
    model axis. Marks a replicated tensor entering a "model"-sharded
    computation (Megatron's f operator)."""
    ctx = active()
    if ctx is None or ctx.size == 1 or not _tracked(x):
        return x
    return _CopyToModel.apply(x, ctx)


def all_gather_cols(x: torch.Tensor) -> torch.Tensor:
    """Gather column-parallel shards along the LAST dim (tiled), so each
    rank leaves with the full-width tensor. Identity outside TP. Its
    backward keeps this rank's columns of the gradient."""
    ctx = active()
    if ctx is None:
        return x
    if _tracked(x):
        # a training step's logits: no copy of them over a group of one
        return x if ctx.size == 1 else _Gather.apply(x, _model(ctx),
                                                     x.ndim - 1, False)
    out = _gather(x, ctx.group, ctx.size, ctx.transport, -1)
    _count(ctx.size, "all-gather", out)
    return out


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """All-gather ``x`` (T, ...) along dim 0 over the fsdp group: every
    data shard's rows in rank order (the MoE "dense" dispatch over the
    global tokens). Its backward keeps this rank's rows. Identity
    outside training on a mesh and over a group of one."""
    ctx = active()
    if ctx is None or ctx.fsdp_size == 1:
        return x
    return _Gather.apply(x, _fsdp(ctx), 0, False)


def fsdp_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a tensor ``gather_rows`` gathered."""
    ctx = active()
    if ctx is None or ctx.fsdp_size == 1:
        return x
    n = x.shape[0] // ctx.fsdp_size
    return x[ctx.fsdp_rank * n:(ctx.fsdp_rank + 1) * n]


def fsdp_dim(pspec) -> int | None:
    """The dim a description shards over the fsdp axes ("pod" /
    "data"), or None."""
    for i, e in enumerate(tuple(pspec)):
        if e is not None and e != "model":
            return i
    return None


def gather_params(params, specs):
    """ZeRO-3 gather of a parameter tree at use (dicts and lists of
    tensors; ``specs`` its sanitized description). A leaf sharded over
    fsdp is all-gathered along its fsdp dim, its gradient
    reduce-scattered back to the shard; a leaf replicated over fsdp is
    returned as it is, its gradient all-reduced over fsdp. The result
    lives only as long as its users: a layer's gathered weights are
    freed after it, and re-gathered by the recompute of a remat
    backward. Identity outside training on a mesh or over an fsdp group
    of one."""
    ctx = active()
    if ctx is None or specs is None or ctx.fsdp_size == 1:
        return params
    axis = _fsdp(ctx)

    def one(t, spec):
        d = fsdp_dim(spec)
        if d is None:
            return _ReduceGrad.apply(t, axis) if _tracked(t) else t
        if _tracked(t):
            return _Gather.apply(t, axis, d, True)
        out = _gather(t, *axis[:2], ctx.transport, d)
        _count(ctx.fsdp_size, "all-gather", out)
        return out

    from repro_torch import tree
    return tree.map_with_spec(one, params, specs)


def all_reduce(x: torch.Tensor, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` reduced ("sum" or "max") over the "model" or "fsdp" group of
    the training context, in place; identity outside one and over a
    group of one (no autograd: scalars of the loss and the optimizer)."""
    ctx = active()
    if ctx is None:
        return x
    group, size, _, transport = _model(ctx) if axis == "model" \
        else _fsdp(ctx)
    if size == 1:
        return x
    _reduce_(x, group, transport,
             dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    _count(size, "all-reduce", x)
    return x


def shard_offset(n_local: int) -> int:
    """Global offset of this shard's slice given its local extent (vocab
    rows, expert ids, ...). 0 outside TP."""
    ctx = active()
    if ctx is None:
        return 0
    return ctx.rank * int(n_local)


def model_only_pspec(pspec) -> tuple:
    """Project a sharding description (a tuple of per-dim entries: an
    axis name, a tuple of names, or None) onto the model axis only.

    Serving TP shards exactly one thing, the head / latent ("model")
    axis; batch and FSDP entries are dropped. Tuple entries like
    ``("pod", "data")`` reduce to their "model" member or None; trailing
    Nones are trimmed, as ``PartitionSpec`` prints them."""
    entries = []
    for e in tuple(pspec):
        if e == "model" or (isinstance(e, (tuple, list)) and "model" in e):
            entries.append("model")
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def model_dim(pspec) -> int | None:
    """The dim a description shards over "model", or None."""
    entries = model_only_pspec(pspec)
    return entries.index("model") if "model" in entries else None
