"""Activation-sharding hints (mirror of ``repro.parallel.hints``).

In the JAX package these are ``with_sharding_constraint``s at the hot
layout boundaries: XLA's sharding propagation lost the batch sharding
of attention activations through the reshape -> transpose -> scan-slice
chain, and attention ran batch-REPLICATED over the data axis. The port
has no propagation to lose: every rank of a mesh holds its own rows
explicitly (``data.pipeline.shard_batch``). So ``constrain`` is an
identity that checks the same promise: inside ``sharding_hints`` a dim
named "batch" must be this rank's share of the step's batch, and a
batch-replicated tensor raises. No-op when no hints are installed
(one device, serving).

Slots, as in the JAX package: "batch" -> the fsdp / batch axes,
"model" -> the TP axis (each rank already holds its heads: not
checked), None. The JAX package's "fsdp" slot shards d_model under its
``tp_activations`` lever, which the port does not have.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def _current():
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def sharding_hints(mesh, minfo, *, batch: int | None = None):
    """Install the hints while a sharded step runs: ``minfo`` carries
    the mesh's axis sizes, ``batch`` the global batch rows of the
    forward the step runs (a microbatch's)."""
    prev = _current()
    _STATE.ctx = (minfo, batch) if mesh is not None else None
    try:
        yield
    finally:
        _STATE.ctx = prev


def carried(fn):
    """``fn`` run under the hints installed now, wherever it is called
    (``parallel.tp.carried``)."""
    ctx = _current()

    def run(*args, **kwargs):
        prev = _current()
        _STATE.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _STATE.ctx = prev

    return run


def constrain(x, dims: tuple):
    """``x`` unchanged; raises when a dim of ``dims`` named "batch" is
    not this rank's share of the installed batch (the global rows over
    the fsdp axes, or all of them when those do not divide it)."""
    ctx = _current()
    if ctx is None or x is None:
        return x
    minfo, batch = ctx
    if batch is None:
        return x
    n = minfo.size(minfo.fsdp)
    share = batch // n if batch % n == 0 else batch
    for i, d in enumerate(dims):
        if d == "batch" and x.shape[i] != share:
            raise ValueError(
                f"dim {i} of a {tuple(x.shape)} tensor is the batch: this "
                f"rank holds {share} of its {batch} rows over "
                f"{minfo.fsdp}, not {x.shape[i]} (a batch-replicated "
                "tensor)")
    return x
