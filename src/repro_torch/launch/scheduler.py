"""Continuous batching over the paged KV pool (mirror of
``repro.launch.scheduler``: ``FinishedRequest``, ``SchedulerStats``, the
``ContinuousBatchingServer`` machinery and
``PagedContinuousBatchingServer``).

What the paged server does, as in the JAX package:

  * **Paged KV** — one physical block pool (``launch.kvpool``); each
    request maps its positions onto pooled blocks through a block table.
    ``kernel="paged"`` (default) decodes IN PLACE on the pool through
    ``kernels.ops.paged_attention_gqa`` (or ``paged_attention_mla`` for
    the MLA family) with tables sliced to the active frontier;
    ``kernel="slab"`` gathers the tables' blocks into a dense slab view
    per segment, decodes on it and scatters them back (the reference
    route).
  * **Prefix caching** — full prompt blocks are hash-consed; a request
    whose prompt starts with a served prefix splices those blocks.
  * **Chunked prefill-ahead** — pending requests' prompt KV stages in
    ``prefill_chunk``-token rounds between decode segments.
  * **Fused admission** — admission is a host-side table splice; the
    correction step (decode of ``prompt[-1]`` at position S-1) is the
    admitted row's first step of the next segment.
  * **Table validation** — every block table is bounds-checked on the
    host (``kvpool.validate_tables``) before each step that launches
    kernels on it: a table-indexed load in CUDA has no bounds check.
  * **Execution plans** — ``plan=`` takes any ``LayerPlan``,
    ``ExecutionPlan`` (uniform or per layer), ``ExecutionMode`` or mode
    name, as the JAX server does. Every step runs under it, so each
    layer's MLP and decode attention take that layer's route
    (``kernels.ops``): the serial or ring Sidebar kernel, or the
    FLEXIBLE_DMA three-launch MLP with gathered-view decode attention.

Differences from the JAX server: a segment is a Python loop of eager
steps, not one scanned program; a request's whole KV span (prompt +
generation) is reserved when its staging starts, since lazy growth
exists to feed preemption, which is not ported. Preemption/spill, EDF
scores, faults, the watchdog, speculative decoding, RAG and tensor
parallelism are not ported: their arguments raise. Decoding is greedy.

On the CPU the port's plain paths accumulate in a fixed order (see
``kernels.ref``), so ``kernel="paged"`` == ``kernel="slab"`` == solo
``serve.generate`` bit-exactly, as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.modes import (
    ExecutionMode,
    ExecutionPlan,
    LayerPlan,
    coerce_layer_plan,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.launch import kvpool as kvp
from repro_torch.launch import sampling
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.models.registry import get_model

# constructor arguments of the JAX servers whose features are not ported
_UNPORTED_KW = {
    "mesh": "tensor parallelism (ROADMAP Queue 1 item 11)",
    "faults": "fault injection (ROADMAP Queue 1 item 8)",
    "scheduling": "EDF/FIFO scheduling (ROADMAP Queue 1 item 8)",
    "spill_region": "preemption and spill (ROADMAP Queue 1 item 8)",
    "spec": "speculative decoding (ROADMAP Queue 1 item 10)",
    "rag": "RAG serving (ROADMAP Queue 1 item 10)",
    "rag_overlap": "RAG serving (ROADMAP Queue 1 item 10)",
    "buckets": "the slot-cache server's bucketed admission",
    "admit_batch": "the slot-cache server's batched admission",
}


def _reject_unported(kw: dict) -> None:
    if kw:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(
                f"{k}= ({_UNPORTED_KW.get(k, 'unknown argument')})"
                for k in sorted(kw)))


@dataclasses.dataclass(frozen=True)
class FinishedRequest:
    """One drained request: the prompt plus every generated token."""

    rid: int
    prompt: np.ndarray        # (S,) int32 — as submitted
    tokens: np.ndarray        # (generated,) int32
    prompt_len: int
    generated: int
    ttft: float = float("nan")   # submit -> first token on the device (s)
    itl: float = float("nan")    # mean inter-token latency (s)


@dataclasses.dataclass(eq=False)
class _Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    submit_t: float = 0.0
    seq: int = 0              # arrival index: the scheduling order


@dataclasses.dataclass
class _Slot:
    rid: int | None = None
    pos: int = 0              # next KV write position (= current length)
    remaining: int = 0
    generated: int = 0
    # generated tokens as (device tensor, row, take) handles, fetched to
    # the host only when the request is handed back
    chunks: list[tuple] = dataclasses.field(default_factory=list)
    prompt: np.ndarray | None = None
    req: _Request | None = None
    first_t: float | None = None

    @property
    def free(self) -> bool:
        return self.rid is None


@dataclasses.dataclass
class SchedulerStats:
    """Scheduler counters."""

    admitted: int = 0
    segments: int = 0
    decode_steps: int = 0
    wasted_steps: int = 0
    stage_chunks: int = 0
    stage_stalls: int = 0
    cow_copies: int = 0
    evictions: int = 0
    prefix_block_lookups: int = 0
    prefix_block_hits: int = 0
    prefix_prompt_blocks: int = 0
    chunk_interior_hits: int = 0
    pool_blocks: int = 0
    pool_in_use: int = 0
    pool_in_use_peak: int = 0
    cancelled: int = 0

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_block_hits / max(self.prefix_prompt_blocks, 1)


class ContinuousBatchingServer:
    """Request/slot machinery shared by the continuous-batching servers:
    submission, retirement, token materialization, ``step``/``run``.

    The slot-cache server of the JAX package (one dense max-length KV
    row per slot, bucketed admission) is not ported; use
    ``PagedContinuousBatchingServer``, which supplies ``_init_kv`` and
    ``_advance``.
    """

    def __init__(self, cfg: ModelConfig, params, *, device=None,
                 num_slots: int = 4, max_len: int = 256, segment: int = 8,
                 plan: LayerPlan | ExecutionPlan | ExecutionMode | str |
                 None = None, **kw) -> None:
        _reject_unported(kw)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the server on {self.device}")
        if plan is None:
            plan = ExecutionMode.SIDEBAR
        if not isinstance(plan, ExecutionPlan):
            plan = coerce_layer_plan(plan)
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.api = get_model(cfg)
        self.num_slots = num_slots
        self.max_len = max_len
        self.segment = segment
        self.slots = [_Slot() for _ in range(num_slots)]
        self.pending: collections.deque = collections.deque()
        self.finished: list[FinishedRequest] = []
        self._next_rid = 0
        # the running token of every slot on the device, (N, 1)
        self._toks = torch.zeros((num_slots, 1), dtype=torch.int64,
                                 device=self.device)
        self._done_raw: list[tuple] = []
        self.stats = SchedulerStats()
        self._seq = 0
        self._clock = time.monotonic
        self._init_kv()

    def _init_kv(self) -> None:
        raise NotImplementedError(
            "the slot-cache ContinuousBatchingServer is not ported; use "
            "PagedContinuousBatchingServer")

    def submit(self, prompt, max_new_tokens: int,
               sample: SamplingParams | None = None, **kw) -> int:
        """Enqueue a request; returns its rid. Greedy only."""
        if kw:
            raise NotImplementedError(
                f"not ported yet: {sorted(kw)} (priorities and SLO "
                "targets come with EDF scheduling, ROADMAP Queue 1 "
                "item 8)")
        sampling.require_greedy(sample)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new_tokens} exceeds "
                f"max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(_Request(rid, prompt, int(max_new_tokens),
                                     submit_t=self._clock(), seq=self._seq))
        self._seq += 1
        return rid

    def _score(self, req: _Request) -> tuple:
        """Scheduling order, smaller = sooner: arrival."""
        return (req.seq,)

    def cancel(self, rid: int) -> bool:
        for req in self.pending:
            if req.rid == rid:
                self.pending.remove(req)
                self.stats.cancelled += 1
                return True
        for i, slot in enumerate(self.slots):
            if slot.rid == rid:
                self._free_slot(i)
                self.stats.cancelled += 1
                return True
        return False

    def _free_slot(self, slot_idx: int) -> None:
        self.slots[slot_idx] = _Slot()

    def _retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        ttft = itl = float("nan")
        if slot.req is not None and slot.first_t is not None:
            ttft = slot.first_t - slot.req.submit_t
            if slot.generated > 1:
                itl = (self._clock() - slot.first_t) / (slot.generated - 1)
        self._done_raw.append((slot.rid, slot.prompt, slot.chunks,
                               slot.generated, ttft, itl))
        self._free_slot(slot_idx)

    @staticmethod
    def _chunks_to_np(chunks: list[tuple], fetched: dict) -> np.ndarray:
        if not chunks:
            return np.zeros((0,), np.int32)
        parts = []
        for arr, row, take in chunks:
            host = fetched.get(id(arr))
            if host is None:
                host = fetched[id(arr)] = arr.cpu().numpy()
            parts.append(host[row, :take])
        return np.concatenate(parts).astype(np.int32)

    def _materialize(self) -> list[FinishedRequest]:
        if not self._done_raw:
            return []
        fetched: dict = {}
        out = []
        for rid, prompt, chunks, generated, ttft, itl in self._done_raw:
            tokens = self._chunks_to_np(chunks, fetched)
            if tokens.size != generated:
                raise RuntimeError(f"rid {rid}: {tokens.size} tokens "
                                   f"materialized, {generated} counted")
            out.append(FinishedRequest(
                rid=rid, prompt=prompt, tokens=tokens,
                prompt_len=int(prompt.size), generated=generated,
                ttft=ttft, itl=itl))
        self._done_raw.clear()
        self.finished.extend(out)
        return out

    def _advance(self, *, draining: bool = False) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, *, draining: bool = False) -> list[FinishedRequest]:
        """One scheduler iteration; returns the requests it finished."""
        self._advance(draining=draining)
        return self._materialize()

    def _has_work(self) -> bool:
        return bool(self.pending) or any(not s.free for s in self.slots)

    @torch.no_grad()
    def run(self) -> list[FinishedRequest]:
        """Drain every pending and active request; returns all finished
        requests ordered by rid."""
        while self._has_work():
            self._advance(draining=True)
        self._materialize()
        out, self.finished = self.finished, []
        return sorted(out, key=lambda r: r.rid)


def _hole_spans(hit_idx: Sequence[int], target: int,
                block_size: int) -> list[list[int]]:
    """Position spans ``[start, end)`` of ``[0, target)`` not covered by
    spliced hit blocks — what staging must still prefill."""
    spans: list[list[int]] = []
    hit = set(hit_idx)
    p = 0
    while p < target:
        j = p // block_size
        if j in hit:
            p = (j + 1) * block_size
            continue
        e = min((j + 1) * block_size, target)
        if spans and spans[-1][1] == p:
            spans[-1][1] = e
        else:
            spans.append([p, e])
        p = e
    return spans


@dataclasses.dataclass(eq=False)
class _Staging:
    """A request whose prompt KV is being staged into the pool;
    ``todo`` holds the position spans still to prefill, in order."""

    req: _Request
    rb: kvp.RequestBlocks
    todo: list[list[int]]

    @property
    def done(self) -> bool:
        return not self.todo


class PagedContinuousBatchingServer(ContinuousBatchingServer):
    """Continuous batching over a block-granular paged KV pool (see the
    module docstring).

    >>> srv = PagedContinuousBatchingServer(cfg, params, num_slots=4,
    ...                                     max_len=1024, block_size=16)
    >>> srv.submit(prompt, max_new_tokens=32)
    >>> done = srv.run()
    """

    def __init__(self, cfg: ModelConfig, params, *, block_size: int = 16,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 stage_ahead: int | None = None, kernel: str = "paged",
                 **kw) -> None:
        if kernel not in ("paged", "slab"):
            raise ValueError(f"kernel must be 'paged' or 'slab', got "
                             f"{kernel!r}")
        self.kernel = kernel
        self.block_size = int(block_size)
        self._num_blocks_arg = num_blocks
        self.prefill_chunk = int(prefill_chunk or block_size)
        self._stage_ahead_arg = stage_ahead
        super().__init__(cfg, params, **kw)
        self._serve_step = make_serve_step(self.cfg, self.api)
        self._prefill_step = make_prefill_step(self.cfg, self.api)

    def _init_kv(self) -> None:
        if self.max_len % self.block_size:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of "
                f"block_size {self.block_size}")
        self.blocks_per_table = self.max_len // self.block_size
        nb = self._num_blocks_arg
        if nb is None:
            # full tables for every slot + staging/prefix slack + scratch
            nb = (self.num_slots + 2) * self.blocks_per_table + 1
        self.mgr = kvp.PagedKVManager(self.api, self.cfg, num_blocks=nb,
                                      block_size=self.block_size,
                                      device=self.device)
        self.stage_ahead = (self._stage_ahead_arg
                            if self._stage_ahead_arg is not None
                            else self.num_slots)
        self._tables = np.full((self.num_slots, self.blocks_per_table),
                               kvp.SCRATCH_BLOCK, np.int32)
        self._slot_rb: list[kvp.RequestBlocks | None] = (
            [None] * self.num_slots)
        self._staging: collections.deque[_Staging] = collections.deque()
        # slot -> correction token of rows admitted this boundary
        self._admit_pending: dict[int, int] = {}
        self.stats.pool_blocks = self.mgr.alloc.capacity

    def _validated(self, tables: np.ndarray) -> torch.Tensor:
        """Bounds-check a table batch on the host, then ship it."""
        kvp.validate_tables(tables, self.mgr.alloc.num_blocks)
        return torch.as_tensor(np.ascontiguousarray(tables),
                               device=self.device)

    def _sync_pool_stats(self) -> None:
        c = self.mgr.counters
        self.stats.cow_copies = c.cow_copies
        self.stats.evictions = c.evictions
        self.stats.prefix_block_lookups = c.prefix_block_lookups
        self.stats.prefix_block_hits = c.prefix_block_hits
        self.stats.prefix_prompt_blocks = c.prompt_blocks
        self.stats.chunk_interior_hits = c.chunk_interior_hits
        self.stats.pool_in_use = self.mgr.alloc.in_use
        self.stats.pool_in_use_peak = c.in_use_peak

    def _has_work(self) -> bool:
        return super()._has_work() or bool(self._staging)

    def submit(self, prompt, max_new_tokens: int,
               sample: SamplingParams | None = None, **kw) -> int:
        prompt_arr = np.asarray(prompt, np.int32).reshape(-1)
        if prompt_arr.size >= 1 and max_new_tokens >= 1:
            need = self.mgr.blocks_needed(
                prompt_arr.size + max_new_tokens - 1)
            if need > self.mgr.alloc.capacity:
                raise ValueError(
                    f"request needs {need} blocks, pool holds "
                    f"{self.mgr.alloc.capacity} — raise num_blocks or "
                    "shrink the request")
        return super().submit(prompt, max_new_tokens, sample, **kw)

    def cancel(self, rid: int) -> bool:
        for st in self._staging:
            if st.req.rid == rid:
                self._staging.remove(st)
                self.mgr.release_request(st.rb)
                self.stats.cancelled += 1
                return True
        return super().cancel(rid)

    # -- chunked prefill-ahead (staging) -----------------------------------
    def _stage_round(self, entries: list[_Staging]) -> None:
        """ONE staging step advances every incomplete entry by up to
        ``prefill_chunk`` tokens, each row at its own frontier through
        its own block table. The zero-padded tail of a final chunk writes
        junk past the prompt; blocks past the last validly written one
        are diverted to the scratch row, so the junk never lands in a
        spliced (shared) block."""
        k, c = len(entries), self.prefill_chunk
        bs = self.block_size
        toks = np.zeros((k, c), np.int64)
        pos = np.empty((k,), np.int64)
        bt = np.empty((k, self.blocks_per_table), np.int32)
        for j, st in enumerate(entries):
            s, e = st.todo[0]
            valid = min(e - s, c)
            toks[j, :valid] = st.req.prompt[s:s + valid]
            pos[j] = s
            row = st.rb.table_row(self.blocks_per_table)
            row[(s + valid - 1) // bs + 1:] = kvp.SCRATCH_BLOCK
            bt[j] = row
        bt_dev = self._validated(bt)
        with kops.execution_plan(self.plan):
            self._prefill_step(
                self.params, {"tokens": torch.as_tensor(toks,
                                                        device=self.device)},
                self.mgr.pool.cache,
                cache_pos=torch.as_tensor(pos, device=self.device),
                block_tables=bt_dev)
        for st in entries:
            s, e = st.todo[0]
            if s + c >= e:
                st.todo.pop(0)
            else:
                st.todo[0][0] = s + c
        self.stats.stage_chunks += k

    def _stage(self, *, catch_up: bool) -> None:
        """Start staging the best-scored pending requests (prefix splice
        + whole-span allocation), then advance every incomplete entry by
        one chunk round — or to completion when nothing decodes
        (``catch_up``)."""
        while self.pending and len(self._staging) < self.stage_ahead:
            req = min(self.pending, key=self._score)
            rb = self.mgr.begin_request(
                req.prompt, int(req.prompt.size) + req.max_new - 1)
            if rb is None:
                self.stats.stage_stalls += 1
                break
            self.pending.remove(req)
            self._staging.append(_Staging(
                req=req, rb=rb,
                todo=_hole_spans(rb.hit_idx, int(req.prompt.size) - 1,
                                 self.block_size)))
        while True:
            work = [st for st in self._staging if not st.done]
            if not work:
                return
            self._stage_round(work)
            if not catch_up:
                return

    # -- admission: a block-table splice, zero dispatches ------------------
    def _admit_ready(self) -> None:
        """Move fully staged requests into free slots, best score first.
        The correction token parks in ``_admit_pending`` until the next
        segment feeds it."""
        ready = sorted((st for st in self._staging if st.done),
                       key=lambda st: self._score(st.req))
        free = [i for i, s in enumerate(self.slots) if s.free]
        for st in ready:
            if not free:
                return
            i = free.pop(0)
            self._staging.remove(st)
            r = st.req
            self.mgr.publish_prompt(r.prompt, st.rb)
            # the first write position S-1 must be exclusively owned;
            # structurally it always is — enforced, not assumed
            wb = (int(r.prompt.size) - 1) // self.block_size
            if wb < len(st.rb.bids):
                self.mgr.ensure_exclusive(st.rb, wb)
            self.slots[i] = _Slot(rid=r.rid, pos=int(r.prompt.size) - 1,
                                  remaining=r.max_new, prompt=r.prompt,
                                  req=r)
            self._tables[i] = st.rb.table_row(self.blocks_per_table)
            self._slot_rb[i] = st.rb
            self._admit_pending[i] = int(r.prompt[-1])
            self.stats.admitted += 1

    def _free_slot(self, slot_idx: int) -> None:
        rb = self._slot_rb[slot_idx]
        if rb is not None:
            self.mgr.release_request(rb)
            self._slot_rb[slot_idx] = None
        self._tables[slot_idx] = kvp.SCRATCH_BLOCK
        self._admit_pending.pop(slot_idx, None)
        super()._free_slot(slot_idx)

    # -- segment decode (admission fused in) -------------------------------
    def _segment_table_width(self, active: list[int], steps: int) -> int:
        """Cover the farthest position any active row attends to after
        ``steps``, rounded up to a power of two, clamped to the table."""
        frontier = max(self.slots[i].pos + steps for i in active)
        nbu = -(-frontier // self.block_size)
        nbu = 1 << max(0, (nbu - 1).bit_length())
        return max(1, min(self.blocks_per_table, nbu))

    def _segment_steps(self, active: list[int], *,
                       draining: bool = False) -> int:
        """Shrink-to-fit: end when the earliest active slot finishes;
        capped at ``segment`` while staging needs boundaries or a live
        submit could enter a free slot; above ``segment`` the length
        rounds down to a power of two."""
        min_rem = min(self.slots[i].remaining for i in active)
        entry_possible = any(not st.done for st in self._staging) or (
            not draining and any(s.free for s in self.slots))
        if entry_possible:
            return min(min_rem, self.segment)
        if min_rem <= self.segment:
            return min_rem
        return 1 << (min_rem.bit_length() - 1)

    def _run_segment(self, steps: int, pos: np.ndarray, aligned: bool,
                     tables: np.ndarray) -> torch.Tensor:
        """``steps`` decode steps over every slot; returns (N, steps)."""
        max_pos = self.max_len - 1
        pool = self.mgr.pool.cache
        if self.kernel == "paged":
            cache = pool
        else:
            bt_dev = self._validated(tables)
            cache = kvp.gather_blocks(pool, bt_dev, self.mgr.pool.pos_axes)
        pos_dev = torch.as_tensor(pos, device=self.device)
        buf = torch.empty((self.num_slots, steps), dtype=torch.int32,
                          device=self.device)
        tok = self._toks
        for i in range(steps):
            p = (min(int(pos[0]) + i, max_pos) if aligned
                 else torch.clamp_max(pos_dev + i, max_pos))
            if self.kernel == "paged":
                # every kernel launch walks these tables: check them
                nxt, _ = self._serve_step(self.params, tok, cache, p,
                                          block_tables=self._validated(
                                              tables))
            else:
                nxt, _ = self._serve_step(self.params, tok, cache, p)
            buf[:, i] = nxt[:, 0]
            tok = nxt.long()
        if self.kernel != "paged":
            kvp.scatter_blocks(pool, cache, bt_dev, self.mgr.pool.pos_axes)
        self._toks = tok
        return buf

    def _advance(self, *, draining: bool = False) -> None:
        active_now = any(not s.free and s.remaining > 0 for s in self.slots)
        self._stage(catch_up=not active_now)
        self._admit_ready()
        self._sync_pool_stats()
        active = [i for i, s in enumerate(self.slots)
                  if not s.free and s.remaining > 0]
        if not active:
            return
        steps = self._segment_steps(active, draining=draining)
        for i in active:
            self.mgr.check_span(self._slot_rb[i], self.slots[i].pos + steps)
        if self._admit_pending:
            idx = sorted(self._admit_pending)
            self._toks[idx] = torch.as_tensor(
                [[self._admit_pending[i]] for i in idx], device=self.device)
            self._admit_pending.clear()
        pos = np.full((self.num_slots,), self.max_len - 1, np.int64)
        for i in active:
            pos[i] = self.slots[i].pos
        aligned = (len(active) == self.num_slots
                   and len({self.slots[i].pos for i in active}) == 1)
        width = (self._segment_table_width(active, steps)
                 if self.kernel == "paged" else self.blocks_per_table)
        with kops.execution_plan(self.plan):
            buf = self._run_segment(steps, pos, aligned,
                                    self._tables[:, :width])
        self.stats.segments += 1
        self.stats.decode_steps += steps * len(active)
        self.stats.wasted_steps += steps * (self.num_slots - len(active))
        if any(self.slots[i].first_t is None for i in active) \
                and self.device.type == "cuda":
            # time to first token is when the token exists on the card,
            # not when its step was enqueued
            torch.cuda.synchronize(self.device)
        now = self._clock()
        for i in active:
            slot = self.slots[i]
            take = min(steps, slot.remaining)
            slot.chunks.append((buf, i, take))
            slot.generated += take
            slot.remaining -= take
            slot.pos += take
            if slot.first_t is None:
                slot.first_t = now
            if slot.remaining == 0:
                self._retire(i)
        self._sync_pool_stats()


__all__ = ["ContinuousBatchingServer", "FinishedRequest",
           "PagedContinuousBatchingServer", "SchedulerStats"]
