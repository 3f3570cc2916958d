"""Continuous batching (mirror of ``repro.launch.scheduler``:
``FinishedRequest``, ``SchedulerStats``, the slot-cache
``ContinuousBatchingServer`` and ``PagedContinuousBatchingServer``).

The slot-cache server, as in the JAX package:

  * **Slot cache** — ONE persistent KV cache with ``num_slots`` batch
    rows, allocated once; each request owns a slot for its lifetime. The
    batch axis of every cache leaf is probed (``kvpool.probe_batch_axes``),
    not assumed.
  * **Bucketed, batched admission** — one admission round prefills every
    co-admitted ``prompt[:-1]`` together, right-padded to the round's
    bucket, then decodes each true last prompt token at its true
    position (the correction step), and scatters the rows back into the
    slot cache. Padding never changes tokens: pad KV past a row's length
    is overwritten by later writes or masked by ``kpos <= pos``.
    Admission hysteresis waits for ``admit_batch`` free slots while a
    backlog and other decoding slots exist, for at most one boundary.
  * **Segment decode** — all occupied slots advance ``segment`` tokens in
    one batched program at per-row positions; its length shrinks to fit
    the earliest finishing slot.

The paged server keeps the slot-cache server's contract on a block pool
(``launch.kvpool``): prefix caching, chunked prefill-ahead, and
admission fused into the next segment (the correction step is the
admitted row's first step). ``kernel="paged"`` decodes in place on the
pool through ``kernels.ops.paged_attention_gqa`` / ``_mla`` with tables
sliced to the active frontier; ``kernel="slab"`` gathers the tables'
blocks into a dense view per segment (the reference route). Tables are
bounds-checked on the host (``kvpool.validate_tables``) once per
segment, before any kernel walks them.

**Sampling** — ``submit(..., sample=SamplingParams(...))``: a request's
base key lives in its slot and the token at index p is keyed by (base
key, p) (``launch.sampling``), so admission order, slot churn, segment
length and a restart mid-stream (resubmit prompt + tokens so far, same
seed) never change the stream. Greedy and sampled rows share one
program: greedy rows carry temperature 0.

**Programs** — admission rounds, staging rounds and segments are
``graphs.Program``s under the JAX package's executable-cache keys:
captured CUDA graphs on the card (per-row positions, tokens, tables and
sampling state copied into static buffers), eager on the CPU or under
``graphs.disable_capture()``. Segments and admission rounds capture at
a key's first call, staging rounds at its ``stage_capture_after``-th
(``STAGE_CAPTURE_AFTER``). ``stats.compiles`` counts keys built,
``stats.hits`` lookups of built ones; each program counts its own
``captures`` and ``replays``. The "aligned"/"ragged" distinction of the
keys is the JAX package's; the port's programs take per-row positions
in both, since a graph cannot take a host scalar.

Differences from the JAX servers: the paged server reserves a request's
whole KV span when its staging starts (lazy growth exists to feed
preemption, which is not ported). Preemption/spill, EDF scores,
priorities, faults, speculative decoding, RAG and tensor parallelism are
not ported: their arguments raise (``serve.UNPORTED``).

On the CPU the plain paths accumulate in a fixed order (see
``kernels.ref``), so slot == paged == slab == solo ``serve.generate``
bit-exactly, as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Sequence

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
from repro_torch.ft.watchdog import SegmentWatchdog
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs
from repro_torch.launch import kvpool as kvp
from repro_torch.launch import sampling
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.serve import (
    PER_LAYER_PLAN_FAMILIES,
    UNPORTED,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models.registry import get_model

# memory-free, batch-row-independent decode — the same set whose stacks
# realize per-layer plans
_SUPPORTED_FAMILIES = PER_LAYER_PLAN_FAMILIES

DEFAULT_BUCKETS = (16, 32, 64, 128)

probe_batch_axes = kvp.probe_batch_axes


def _reject_unported(kw: dict) -> None:
    if kw:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(
                f"{k}= ({UNPORTED.get(k, 'unknown argument')})"
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
    sample: SamplingParams | None = None
    submit_t: float = 0.0
    seq: int = 0              # arrival index: the scheduling order
    priority: int = 0         # one class until EDF is ported


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
    sample: SamplingParams | None = None
    # the request's base key ((2,) int64): position-keyed at use
    key: torch.Tensor | None = None
    req: _Request | None = None
    first_t: float | None = None

    @property
    def free(self) -> bool:
        return self.rid is None


@dataclasses.dataclass
class SchedulerStats:
    """Scheduler counters (attribute access, or indexing by name as in
    the JAX package). ``compiles``/``hits`` are the executable cache: keys
    built and lookups of built keys (captured graphs and their replays
    on the card)."""

    # executable cache
    compiles: int = 0
    hits: int = 0
    # admission / decode
    admitted: int = 0
    segments: int = 0
    decode_steps: int = 0
    wasted_steps: int = 0
    admit_deferrals: int = 0
    # paged pool (PagedContinuousBatchingServer only)
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
    watchdog_events: int = 0   # segments past k * median segment wall
    # latency samples (seconds) per priority class (one class, 0, until
    # EDF priorities are ported)
    ttft_s: dict = dataclasses.field(default_factory=dict)
    itl_s: dict = dataclasses.field(default_factory=dict)

    def __getitem__(self, key: str) -> int:
        return getattr(self, key)

    def record_ttft(self, priority: int, seconds: float) -> None:
        self.ttft_s.setdefault(priority, []).append(float(seconds))

    def record_itl(self, priority: int, seconds: float) -> None:
        self.itl_s.setdefault(priority, []).append(float(seconds))

    @staticmethod
    def _tail(samples: dict, q: float, priority: int | None) -> float:
        xs = (samples.get(priority, []) if priority is not None
              else [x for v in samples.values() for x in v])
        return float(np.percentile(xs, q)) if xs else float("nan")

    def ttft_tail(self, q: float = 95.0,
                  priority: int | None = None) -> float:
        return self._tail(self.ttft_s, q, priority)

    def itl_tail(self, q: float = 95.0,
                 priority: int | None = None) -> float:
        return self._tail(self.itl_s, q, priority)

    @property
    def exec_hit_rate(self) -> float:
        return self.hits / max(self.compiles + self.hits, 1)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_block_hits / max(self.prefix_prompt_blocks, 1)

    @property
    def wasted_step_frac(self) -> float:
        return self.wasted_steps / max(self.decode_steps, 1)

    def summary(self) -> str:
        """One printable line per concern (the serving driver's report)."""
        lines = [
            f"executable cache: {self.compiles} compiles, {self.hits} hits "
            f"({self.exec_hit_rate:.0%} hit rate)",
            f"admission: {self.admitted} admitted, "
            f"{self.admit_deferrals} deferrals",
            f"decode: {self.segments} segments, {self.decode_steps} "
            f"slot-steps, wasted_step_frac {self.wasted_step_frac:.2f}",
        ]
        if self.pool_blocks:
            lines.append(
                f"kv pool: {self.pool_in_use}/{self.pool_blocks} blocks "
                f"(peak {self.pool_in_use_peak}), "
                f"prefix hit rate {self.prefix_hit_rate:.0%} "
                f"({self.prefix_block_hits}/{self.prefix_prompt_blocks} "
                f"blocks, {self.chunk_interior_hits} interior), "
                f"{self.stage_chunks} staged chunks, "
                f"{self.stage_stalls} stalls, {self.cow_copies} COW, "
                f"{self.evictions} evictions")
        if self.cancelled or self.watchdog_events:
            lines.append(f"robustness: {self.cancelled} cancelled, "
                         f"{self.watchdog_events} watchdog events")
        return "\n".join(lines)


class ContinuousBatchingServer:
    """Slot-based continuous batching with batched segment decode (see
    the module docstring).

    >>> srv = ContinuousBatchingServer(cfg, params, num_slots=4)
    >>> srv.submit([1, 2, 3], max_new_tokens=16)
    >>> srv.submit([4, 5], 16, sample=SamplingParams(temperature=0.8))
    >>> done = srv.run()          # drain pending + active
    """

    def __init__(self, cfg: ModelConfig, params, *, device=None,
                 num_slots: int = 4, max_len: int = 256,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 segment: int = 8, admit_batch: int = 2,
                 plan: LayerPlan | ExecutionPlan | ExecutionMode | str |
                 None = None, **kw) -> None:
        _reject_unported(kw)
        if cfg.family not in _SUPPORTED_FAMILIES:
            raise ValueError(
                f"continuous batching supports families {_SUPPORTED_FAMILIES}"
                f", got {cfg.family!r} (encoder-memory families need "
                "per-request memory plumbing)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the server on {self.device}")
        if plan is None:
            plan = ExecutionMode.SIDEBAR
        if isinstance(plan, ExecutionPlan):
            self._plan_key: Any = plan.cache_key()
        else:
            plan = coerce_layer_plan(plan)
            self._plan_key = plan
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.api = get_model(cfg)
        self.num_slots = num_slots
        self.max_len = max_len
        # a bucket longer than the KV cache could never be prefilled into
        # it; exact fit covers what the dropped buckets would have
        self.buckets = tuple(sorted(b for b in buckets if b <= max_len))
        self.segment = segment
        self.admit_batch = max(1, min(admit_batch, num_slots))
        self.slots = [_Slot() for _ in range(num_slots)]
        self.pending: collections.deque = collections.deque()
        self.finished: list[FinishedRequest] = []
        self._next_rid = 0
        self._exec: dict[tuple, Callable] = {}
        self._pool = graphs.new_pool(self.device)
        # the running token of every slot on the device, (N, 1): written
        # only by the programs, in place (a graph holds its address)
        self._toks = torch.zeros((num_slots, 1), dtype=torch.int64,
                                 device=self.device)
        self._done_raw: list[tuple] = []
        self._deferred = False             # admission hysteresis armed
        self.stats = SchedulerStats()
        self._seq = 0
        self._clock = time.monotonic
        self._timer = time.perf_counter
        self.watchdog = SegmentWatchdog()
        self._init_kv()

    def _init_kv(self) -> None:
        """The slot cache (hook: the paged subclass builds its pool)."""
        self.axes = probe_batch_axes(self.api, self.cfg, self.max_len)
        self.cache = self.api.init_cache(self.cfg, self.num_slots,
                                         self.max_len, device=self.device)

    # -- executable cache --------------------------------------------------
    @property
    def captured(self) -> bool:
        """Whether this server's programs replay graphs."""
        return graphs.captures(self.device)

    def _program(self, fn: Callable, capture_after: int = 1
                 ) -> graphs.Program:
        return graphs.Program(fn, device=self.device, pool=self._pool,
                              capture_after=capture_after)

    def _compiled(self, key: tuple, builder: Callable[[], Callable]):
        """(kind, shape-key..., plan) + (mesh,) -> program: a new key is
        a recorded compile, a known one a hit."""
        key = key + (None,)
        fn = self._exec.get(key)
        if fn is None:
            fn = self._exec[key] = builder()
            self.stats.compiles += 1
        else:
            self.stats.hits += 1
        return fn

    def executable_cache_keys(self) -> list[tuple]:
        return sorted(self._exec, key=repr)

    def programs(self) -> list[graphs.Program]:
        return [p for p in self._exec.values()
                if isinstance(p, graphs.Program)]

    # -- submission --------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (prefill length); exact fit past the end."""
        for b in self.buckets:
            if b >= n:
                return b
        return n

    def submit(self, prompt, max_new_tokens: int,
               sample: SamplingParams | None = None, **kw) -> int:
        """Enqueue a request; returns its rid. ``sample=None`` decodes
        greedy; a ``SamplingParams`` gives the request its own
        temperature / truncation / seed."""
        if kw:
            raise NotImplementedError(
                f"not ported yet: {sorted(kw)} ({UNPORTED['priority']})")
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
                                     sample, submit_t=self._clock(),
                                     seq=self._seq))
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

    # -- admission ---------------------------------------------------------
    def _admit_fn(self, *, with_prefill: bool) -> Callable:
        """One program for a whole admission round, in place on the slot
        cache: gather the freed rows (probed batch axes), right-padded
        batched prefill of every ``prompt[:-1]`` (skipped when all
        prompts are single tokens), the correction step at per-row
        positions, the scatter back, and the merge of the first tokens
        into the running token vector. The gathered rows still hold
        retired requests' KV, overwritten or masked before it is read."""
        prefill_step = make_prefill_step(self.cfg, self.api)
        serve_step = make_serve_step(self.cfg, self.api)
        axes = self.axes

        def admit(fixed, padded, toks, pos, slots, sample):
            params, full, run_toks = fixed
            rows = [{name: leaf.index_select(ax[name], slots)
                     for name, leaf in layer.items()}
                    for layer, ax in zip(full, axes)]
            if with_prefill:
                _, rows = prefill_step(params, {"tokens": padded}, rows)
            nxt, rows = serve_step(params, toks, rows, pos, sample)
            for layer, row, ax in zip(full, rows, axes):
                for name, leaf in layer.items():
                    leaf.index_copy_(ax[name], slots, row[name])
            run_toks[slots] = nxt.long()
            return nxt

        return admit

    def _admit_batch(self, slot_idxs: list[int],
                     reqs: list[_Request]) -> None:
        """Admit ``k`` requests in ONE program: the freed rows gathered,
        prefilled to the round's bucket, corrected at their true
        positions and scattered back. A sampled request samples its
        first token with key (base, S), as a solo ``Server.generate``
        does."""
        k = len(reqs)
        s_true = np.asarray([r.prompt.size for r in reqs], np.int64)
        need = int(s_true.max()) - 1
        bucket = self.bucket_for(need) if need > 0 else 0
        padded = None
        if bucket:
            buf = np.zeros((k, bucket), np.int64)
            for j, r in enumerate(reqs):
                buf[j, : r.prompt.size - 1] = r.prompt[:-1]
            padded = torch.as_tensor(buf, device=self.device)
        keys = [None if r.sample is None else sampling.request_key(
            r.sample.seed) for r in reqs]
        sampled = any(r.sample is not None for r in reqs)
        zero = torch.zeros((2,), dtype=torch.int64)
        state = sampling.merge_rows(
            [(zero if key is None else key, r.sample)
             for key, r in zip(keys, reqs)],
            self.device) if sampled else None
        admit = self._compiled(
            ("prefill", k, bucket, self._plan_key,
             "sampled" if sampled else "greedy"),
            lambda: self._program(self._admit_fn(with_prefill=bool(bucket))))
        toks = np.asarray([[r.prompt[-1]] for r in reqs], np.int64)
        nxt = admit(
            (self.params, self.cache, self._toks),
            padded=padded, toks=torch.as_tensor(toks, device=self.device),
            pos=torch.as_tensor(s_true - 1, device=self.device),
            slots=torch.as_tensor(slot_idxs, device=self.device),
            sample=state)
        if self.device.type == "cuda":
            # time to first token: when the token exists on the card
            torch.cuda.synchronize(self.device)
        now = self._clock()
        for j, slot_idx in enumerate(slot_idxs):
            r = reqs[j]
            self.slots[slot_idx] = _Slot(
                rid=r.rid, pos=int(s_true[j]), remaining=r.max_new - 1,
                generated=1, chunks=[(nxt, j, 1)], prompt=r.prompt,
                sample=r.sample, key=keys[j], req=r, first_t=now)
            self.stats.record_ttft(r.priority, now - r.submit_t)
            self.stats.admitted += 1
            if self.slots[slot_idx].remaining == 0:
                self._retire(slot_idx)

    def admit(self) -> int:
        """Fill free slots from the pending queue (one batched admission
        round); returns #admitted. Hysteresis: with a backlog and other
        slots still decoding, wait until ``admit_batch`` slots are free —
        for at most one (segment-capped) boundary."""
        free = [i for i, slot in enumerate(self.slots) if slot.free]
        take = min(len(free), len(self.pending))
        if take == 0:
            self._deferred = False
            return 0
        threshold = min(self.admit_batch, len(self.pending))
        if (take < threshold and len(free) < self.num_slots
                and not self._deferred):
            self._deferred = True
            self.stats.admit_deferrals += 1
            return 0
        self._deferred = False
        reqs = sorted(self.pending, key=self._score)[:take]
        for r in reqs:
            self.pending.remove(r)
        with kops.execution_plan(self.plan):
            self._admit_batch(free[:take], reqs)
        return take

    # -- retirement and tokens ---------------------------------------------
    def _free_slot(self, slot_idx: int) -> None:
        self.slots[slot_idx] = _Slot()

    def _retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        ttft = itl = float("nan")
        if slot.req is not None and slot.first_t is not None:
            ttft = slot.first_t - slot.req.submit_t
            if slot.generated > 1:
                itl = (self._clock() - slot.first_t) / (slot.generated - 1)
                self.stats.record_itl(slot.req.priority, itl)
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

    def slot_tokens(self, slot_idx: int) -> np.ndarray:
        """Tokens generated so far by the request in ``slot_idx`` (syncs
        that slot's chunks; mid-stream inspection and restart)."""
        return self._chunks_to_np(self.slots[slot_idx].chunks, {})

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

    # -- segment decode ----------------------------------------------------
    def _segment_fn(self, num_steps: int) -> Callable:
        """All slots advance ``num_steps`` tokens in one program: one
        batched serve step over the whole slot cache a step, at per-row
        positions; free slots idle at the clamped last position (their
        writes land on a dead row, overwritten at the next admission).
        The final token goes back into the running token vector."""
        step = make_serve_step(self.cfg, self.api)
        max_pos = self.max_len - 1

        def segment(fixed, pos, sample):
            params, cache, run_toks = fixed
            buf = torch.empty((run_toks.shape[0], num_steps),
                              dtype=torch.int32, device=run_toks.device)
            tok = run_toks
            for i in range(num_steps):
                nxt, _ = step(params, tok, cache,
                              torch.clamp_max(pos + i, max_pos), sample)
                buf[:, i] = nxt[:, 0]
                tok = nxt.long()
            run_toks.copy_(tok)
            return buf

        return segment

    def _segment_sample_state(self, active: list[int]) -> dict | None:
        """Per-row sampling state for one segment, or ``None`` when every
        active slot decodes greedily (the greedy program has no sampling
        math). Greedy and free slots ride along as temperature-0 rows."""
        if not any(self.slots[i].sample is not None for i in active):
            return None
        zero = torch.zeros((2,), dtype=torch.int64)
        rows = [(zero, None) if s.free or s.sample is None
                else (s.key, s.sample) for s in self.slots]
        return sampling.merge_rows(rows, self.device)

    def _segment_steps(self, active: list[int], *,
                       draining: bool = False) -> int:
        """Shrink-to-fit: end when the earliest active slot finishes;
        capped at ``segment`` when something could enter at the boundary
        (an armed admission deferral, or a free slot a live submit could
        take); above ``segment`` the length rounds down to a power of
        two."""
        min_rem = min(self.slots[i].remaining for i in active)
        entry_possible = self._deferred or (
            not draining and any(s.free for s in self.slots))
        if entry_possible:
            return min(min_rem, self.segment)
        if min_rem <= self.segment:
            return min_rem
        return 1 << (min_rem.bit_length() - 1)

    def _positions(self, active: list[int]) -> tuple[np.ndarray, bool]:
        """(N,) positions (free rows at the last position) and whether
        every slot is occupied at one position (the JAX package's
        aligned program)."""
        pos = np.full((self.num_slots,), self.max_len - 1, np.int64)
        for i in active:
            pos[i] = self.slots[i].pos
        aligned = (len(active) == self.num_slots
                   and len({self.slots[i].pos for i in active}) == 1)
        return pos, aligned

    def _observe(self, t0: float) -> None:
        """Feed one segment's dispatch wall time to the watchdog."""
        if self.watchdog.observe(self._timer() - t0):
            self.stats.watchdog_events += 1

    def _account(self, active: list[int], steps: int,
                 buf: torch.Tensor) -> None:
        """Hand a segment's tokens to its slots; retire finished ones."""
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
                if slot.req is not None:
                    self.stats.record_ttft(slot.req.priority,
                                           now - slot.req.submit_t)
            if slot.remaining == 0:
                self._retire(i)

    def _advance(self, *, draining: bool = False) -> None:
        """One scheduler iteration: admit into free slots, then one
        segment over all active slots. Decisions derive from host-side
        counts; token values stay on the device."""
        self.admit()
        active = [i for i, s in enumerate(self.slots)
                  if not s.free and s.remaining > 0]
        if not active:
            return
        steps = self._segment_steps(active, draining=draining)
        pos, aligned = self._positions(active)
        state = self._segment_sample_state(active)
        seg = self._compiled(
            ("segment", self.num_slots, steps,
             "aligned" if aligned else "ragged",
             "sampled" if state is not None else "greedy",
             self._plan_key),
            lambda: self._program(self._segment_fn(steps)))
        t0 = self._timer()
        with kops.execution_plan(self.plan):
            buf = seg((self.params, self.cache, self._toks),
                      pos=torch.as_tensor(pos, device=self.device),
                      sample=state)
        self._observe(t0)
        self._account(active, steps, buf)

    @torch.no_grad()
    def step(self, *, draining: bool = False) -> list[FinishedRequest]:
        """One scheduler iteration; returns the requests it finished."""
        self._advance(draining=draining)
        return self._materialize()

    def _has_work(self) -> bool:
        return bool(self.pending) or any(not s.free for s in self.slots)

    @property
    def load(self) -> int:
        """Outstanding requests: queued + occupying a slot."""
        return len(self.pending) + sum(not s.free for s in self.slots)

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


# A staging key is captured at its 16th round (``graphs.Program``'s
# ``capture_after``); the rounds before run eagerly. A staging round is
# one prefill call whose time is mostly the card's: at nemotron-4-15b's
# widths on an H100 (chip_smoke.py phase 2, every key captured at its
# first round against none), a replayed round saves ~0.03 s of host
# time against an eager one and a key's capture costs 0.24-0.37 s, so a
# key pays its capture back after some 8-12 replays. A cold drain runs
# each key a few times (8 requests of 32-256 tokens in chunks of 16: at
# most 13 rounds a key), so it stages eagerly; a server that keeps
# seeing a key captures it.
STAGE_CAPTURE_AFTER = 16


class PagedContinuousBatchingServer(ContinuousBatchingServer):
    """Continuous batching over a block-granular paged KV pool (see the
    module docstring).

    >>> srv = PagedContinuousBatchingServer(cfg, params, num_slots=4,
    ...                                     max_len=1024, block_size=16)
    >>> srv.submit(prompt, max_new_tokens=32)
    >>> done = srv.run()

    ``buckets`` and ``admit_batch`` belong to the slot cache's admission
    and are ignored here (staging replaces it), as in the JAX package.
    """

    def __init__(self, cfg: ModelConfig, params, *, block_size: int = 16,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 stage_ahead: int | None = None, kernel: str = "paged",
                 stage_capture_after: int = STAGE_CAPTURE_AFTER,
                 **kw) -> None:
        if kernel not in ("paged", "slab"):
            raise ValueError(f"kernel must be 'paged' or 'slab', got "
                             f"{kernel!r}")
        self.kernel = kernel
        self.block_size = int(block_size)
        self._num_blocks_arg = num_blocks
        self.prefill_chunk = int(prefill_chunk or block_size)
        self._stage_ahead_arg = stage_ahead
        self.stage_capture_after = int(stage_capture_after)
        super().__init__(cfg, params, **kw)
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
        self.cache = None  # the pool replaces the slab entirely
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
    def _stage_fn(self) -> Callable:
        """One staging round as a program: the (k, c) chunk prefilled at
        per-row positions ``pos`` through the rows' ``tables``, in place
        on the pool. Every row count, position and table entry is an
        input, so one graph serves every round of its key."""
        prefill_step = self._prefill_step

        def stage(fixed, tokens, pos, tables):
            params, pool = fixed
            prefill_step(params, {"tokens": tokens}, pool, cache_pos=pos,
                         block_tables=tables)
            return ()

        return stage

    def _stage_round(self, entries: list[_Staging]) -> None:
        """ONE staging step advances every incomplete entry by up to
        ``prefill_chunk`` tokens, each row at its own frontier through
        its own block table, one program under the JAX package's
        ``stage`` key. The zero-padded tail of a final chunk writes junk
        past the prompt; the tables the round is given divert blocks past
        the last validly written one to the scratch row, so the junk never
        lands in a spliced (shared) block."""
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
        stage = self._compiled(
            ("stage", k, c, self.blocks_per_table, self._plan_key),
            lambda: self._program(self._stage_fn(),
                                  self.stage_capture_after))
        with kops.execution_plan(self.plan):
            stage((self.params, self.mgr.pool.cache),
                  tokens=torch.as_tensor(toks, device=self.device),
                  pos=torch.as_tensor(pos, device=self.device),
                  tables=self._validated(bt))
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
            self.slots[i] = _Slot(
                rid=r.rid, pos=int(r.prompt.size) - 1, remaining=r.max_new,
                prompt=r.prompt, sample=r.sample,
                key=(None if r.sample is None
                     else sampling.request_key(r.sample.seed)),
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

    def _paged_segment_fn(self, num_steps: int, admit_k: int) -> Callable:
        """The slot cache's segment on a dense view of the tables' blocks
        (``kernel="slab"``, the reference route): the admitted rows'
        correction tokens merged into the running tokens, the blocks
        gathered once, every step decoded on the view, the blocks
        scattered back."""
        step = make_serve_step(self.cfg, self.api)
        max_pos = self.max_len - 1
        pos_axes = self.mgr.pool.pos_axes

        def segment(fixed, pos, tables, admit_slots, admit_toks, sample):
            params, pool, run_toks = fixed
            if admit_k:
                run_toks[admit_slots] = admit_toks
            dense = kvp.gather_blocks(pool, tables, pos_axes)
            buf = torch.empty((run_toks.shape[0], num_steps),
                              dtype=torch.int32, device=run_toks.device)
            tok = run_toks
            for i in range(num_steps):
                nxt, _ = step(params, tok, dense,
                              torch.clamp_max(pos + i, max_pos), sample)
                buf[:, i] = nxt[:, 0]
                tok = nxt.long()
            kvp.scatter_blocks(pool, dense, tables, pos_axes)
            run_toks.copy_(tok)
            return buf

        return segment

    def _paged_kernel_segment_fn(self, num_steps: int,
                                 admit_k: int) -> Callable:
        """The slab-free segment: every step decodes IN PLACE on the
        pool, its attention walking the tables (already sliced to the
        active frontier); admission merge as in the slab segment."""
        step = make_serve_step(self.cfg, self.api)
        max_pos = self.max_len - 1

        def segment(fixed, pos, tables, admit_slots, admit_toks, sample):
            params, pool, run_toks = fixed
            if admit_k:
                run_toks[admit_slots] = admit_toks
            buf = torch.empty((run_toks.shape[0], num_steps),
                              dtype=torch.int32, device=run_toks.device)
            tok = run_toks
            for i in range(num_steps):
                nxt, _ = step(params, tok, pool,
                              torch.clamp_max(pos + i, max_pos), sample,
                              block_tables=tables)
                buf[:, i] = nxt[:, 0]
                tok = nxt.long()
            run_toks.copy_(tok)
            return buf

        return segment

    def _run_segment(self, steps: int, pos: np.ndarray, aligned: bool,
                     tables: np.ndarray) -> torch.Tensor:
        """``steps`` decode steps over every slot, the rows admitted at
        this boundary fed their correction tokens first: one program
        under the JAX package's segment key (its table width included).
        The tables are bounds-checked once, on the host, before any
        kernel of the segment walks them. Returns the (N, steps)
        tokens."""
        active = [i for i, s in enumerate(self.slots)
                  if not s.free and s.remaining > 0]
        state = self._segment_sample_state(active)
        admits = sorted(self._admit_pending.items())
        self._admit_pending.clear()
        admit_k = len(admits)
        seg_fn = (self._paged_kernel_segment_fn if self.kernel == "paged"
                  else self._paged_segment_fn)
        seg = self._compiled(
            ("pseg", self.num_slots, steps,
             "aligned" if aligned else "ragged",
             "sampled" if state is not None else "greedy",
             admit_k, self.kernel, int(tables.shape[1]), self._plan_key),
            lambda: self._program(seg_fn(steps, admit_k)))
        a_slots = a_toks = None
        if admit_k:
            a_slots = torch.as_tensor([i for i, _ in admits],
                                      device=self.device)
            a_toks = torch.as_tensor([[t] for _, t in admits],
                                     dtype=torch.int64, device=self.device)
        return seg((self.params, self.mgr.pool.cache, self._toks),
                   pos=torch.as_tensor(pos, device=self.device),
                   tables=self._validated(tables), admit_slots=a_slots,
                   admit_toks=a_toks, sample=state)

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
        pos, aligned = self._positions(active)
        width = (self._segment_table_width(active, steps)
                 if self.kernel == "paged" else self.blocks_per_table)
        t0 = self._timer()
        with kops.execution_plan(self.plan):
            buf = self._run_segment(steps, pos, aligned,
                                    self._tables[:, :width])
        self._observe(t0)
        self._account(active, steps, buf)
        self._sync_pool_stats()


__all__ = ["ContinuousBatchingServer", "DEFAULT_BUCKETS", "FinishedRequest",
           "PagedContinuousBatchingServer", "SchedulerStats",
           "probe_batch_axes"]
