"""A world of spawned ranks in one call, for tests and ``chip_smoke.py``.

``run_ranks(fn, world)`` starts ``world`` processes (``spawn``), joins
them into one gloo ``torch.distributed`` world through a ``FileStore``
(no network address: a file in a temporary directory), runs
``fn(rank, *args)`` in each and returns the results by rank. Every rank has a
deadline of its own: a rank that raises, dies or outlives ``timeout``
seconds fails the call at once, and every rank still running is
killed, so a hung collective costs seconds, not the caller's own time
limit. ``fn`` must be importable by the children (a module-level
function) and its result picklable.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank: int, world: int, store: str, timeout: float,
               args: tuple, out) -> None:
    # gloo's transport on the loopback device: the ranks share a host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *, args: tuple = (),
              timeout: float = 120.0,
              store_dir: str | None = None) -> list[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    process of a ``world``-rank gloo world (its collectives bounded by
    ``timeout`` too; ``fn`` makes its mesh's groups, of any backend); the
    store's file lives in ``store_dir`` (default: a new temporary
    directory)."""
    store_dir = store_dir or tempfile.mkdtemp(prefix="repro-ranks-")
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, store, timeout, args,
                               out))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    errors: list[str] = []
    try:
        while len(results) < world and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"ranks {sorted(set(range(world)) - set(results))}"
                              f" did not finish within {timeout} s")
                break
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                continue
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank} raised:\n{val}")
        for p in procs:
            p.join(max(0.0, min(10.0, deadline - time.monotonic()))
                   if not errors else 0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        out.close()
    if errors:
        raise RuntimeError("; ".join(errors))
    return [results[r] for r in range(world)]
