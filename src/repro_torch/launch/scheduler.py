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

**Overload** — as in the JAX servers: requests carry a priority class
and SLO targets (``submit(..., priority=, ttft_target=, itl_target=)``),
and ``scheduling="edf"`` (the default) orders staging, admission and
preemption by (priority, TTFT deadline, arrival), ``"fifo"`` by arrival.
The paged server allocates lazily: staging takes the prompt's blocks
only, and ``_grow_active`` grows each active span block by block before
a segment. When the pool cannot cover a better-scored request, the
scheduler reclaims from strictly worse holders: a staging entry is
unstaged, an active row is spilled (its tokens synced, its KV blocks
copied to host memory and parked in a ``core.sidebar.SidebarSpillRegion``,
every pool block released) and restored later, position-exact. Spill
and restore run at segment boundaries, never inside a capture, and a
restore writes into the pool's leaves in place. ``faults=`` (a
``launch.faults.FaultInjector``) fires at the ``alloc``,
``evict_storm`` and ``stage_stall`` sites; ``take_spilled`` /
``submit_spilled`` hand spilled requests to the replica router
(``launch.router``).

**Speculative decoding** — ``spec=SpecConfig(...)`` (``launch.spec``)
makes each iteration draft -> verify -> commit: the draft model
proposes ``spec.k`` tokens a row from its own dense slot cache, the
target verifies all k + 1 positions in one rowwise program through the
block tables, its drafted positions written into per-slot spare rows of
the pool that the allocator never sees, and the host commits the
accepted prefix (and the target's token after it) by span growth and a
scratch -> pool copy of just the blocks the accepted span reaches. Draft
and verify are programs like the segments (keys ``("draft", n, k)`` and
``("specv", n, k, width, sampled|greedy, plan)``); the host reads the
drafts before the verify and the targets after it — the two syncs of a
speculative step, by design. The stream equals plain decode's for any
draft, greedy and sampled.

**RAG** — ``rag=RagPipeline(...)`` (``retrieval``): ``submit_query``
parks a query; with ``rag_overlap`` (the default) its search starts at
once on a single background worker and is collected right after the
next segment's (or verify's) dispatch, before the host first reads
that program's tokens, so retrieval hides behind the card's decode;
``rag_overlap=False`` quiesces the card and retrieves serially. The
assembled prompt then takes the plain submit path; its retrieved-chunk
blocks are counted against the prefix index's hits.

**Tensor parallelism** — ``mesh=`` (a ``launch.mesh.Mesh``): every rank
runs the same scheduler on the same traffic, its programs on the
rank's shard of the params and of the slot cache or pool
(``serve.TpSpec``), the collectives inside the steps. Tables, positions
and tokens are replicated host metadata; the gathered logits give every
rank the same tokens, so the ranks' host schedules stay in step. Every
executable-cache key ends in the mesh ((shape, axis names), None
without one). The speculative verify step under a mesh is not ported
(ROADMAP Queue 1 item 6).

On the CPU the plain paths accumulate in a fixed order (see
``kernels.ref``), so slot == paged == slab == solo ``serve.generate``
bit-exactly, as in the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import math
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
from repro_torch.core.sidebar import SidebarSpillRegion
from repro_torch.ft.watchdog import SegmentWatchdog
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs
from repro_torch.launch import kvpool as kvp
from repro_torch.launch import sampling
from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.serve import (
    PER_LAYER_PLAN_FAMILIES,
    make_prefill_step,
    make_serve_step,
    make_tp_spec,
    make_verify_step,
    server_device,
)
from repro_torch.launch.spec import (
    SpecConfig,
    accepted_prefix,
    make_draft_program,
)
from repro_torch.models.registry import get_model

# memory-free, batch-row-independent decode — the same set whose stacks
# realize per-layer plans
_SUPPORTED_FAMILIES = PER_LAYER_PLAN_FAMILIES

DEFAULT_BUCKETS = (16, 32, 64, 128)

probe_batch_axes = kvp.probe_batch_axes


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
    """A submitted request while it waits (pending, staging, spilled).
    ``priority`` is its class (higher wins); ``ttft_target`` makes the
    EDF deadline (no target: deadline inf, best-effort);
    ``itl_target`` is recorded; ``seq`` (arrival) breaks every tie, so
    scores are a strict total order."""

    rid: int
    prompt: np.ndarray
    max_new: int
    sample: SamplingParams | None = None
    priority: int = 0
    ttft_target: float | None = None
    itl_target: float | None = None
    submit_t: float = 0.0
    seq: int = 0

    @property
    def deadline(self) -> float:
        return (math.inf if self.ttft_target is None
                else self.submit_t + self.ttft_target)


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
    # overload (preemption / cancel / watchdog)
    preemptions: int = 0       # active slots spilled to the host region
    restores: int = 0          # spilled requests spliced back
    unstaged: int = 0          # staging entries reclaimed back to pending
    spilled_blocks: int = 0
    restored_blocks: int = 0
    cancelled: int = 0
    watchdog_events: int = 0   # segments past k * median segment wall
    # speculative decoding (the paged server with ``spec=``); under it
    # ``decode_steps`` counts emitted tokens and ``wasted_steps`` the
    # rejected remainder
    spec_steps: int = 0        # draft + verify iterations
    spec_drafted: int = 0      # draft tokens given to the verifier
    spec_accepted: int = 0     # of those, equal to the target's
    spec_commit_copies: int = 0  # scratch -> pool block copies
    # retrieval (the paged server with ``rag=``)
    retrievals: int = 0             # queries assembled
    retrieval_overlapped: int = 0   # of those, behind a dispatch
    retrieval_chunk_blocks: int = 0  # retrieved-chunk blocks staged
    retrieval_chunk_hits: int = 0    # of those, spliced from the index
    # latency samples (seconds) per priority class; ``router.sum_stats``
    # concatenates them
    ttft_s: dict = dataclasses.field(default_factory=dict)
    itl_s: dict = dataclasses.field(default_factory=dict)

    def __getitem__(self, key: str) -> int:
        return getattr(self, key)

    def __setitem__(self, key: str, value: int) -> None:
        setattr(self, key, value)

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
    def retrieval_chunk_hit_rate(self) -> float:
        """Retrieved-chunk blocks spliced from the KV index rather than
        prefilled, over those staged."""
        return (self.retrieval_chunk_hits
                / max(self.retrieval_chunk_blocks, 1))

    @property
    def retrieval_overlap_frac(self) -> float:
        """Retrievals collected behind an in-flight dispatch."""
        return self.retrieval_overlapped / max(self.retrievals, 1)

    @property
    def pool_occupancy(self) -> float:
        return self.pool_in_use / max(self.pool_blocks, 1)

    @property
    def wasted_step_frac(self) -> float:
        return self.wasted_steps / max(self.decode_steps, 1)

    @property
    def spec_acceptance_rate(self) -> float:
        """Drafted tokens the target accepted (1.0: the oracle draft's
        ceiling); the tokens never depend on it, throughput does."""
        return self.spec_accepted / max(self.spec_drafted, 1)

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
        if self.spec_steps:
            lines.append(
                f"speculative: {self.spec_steps} steps, "
                f"{self.spec_accepted}/{self.spec_drafted} drafts accepted "
                f"({self.spec_acceptance_rate:.0%}), "
                f"{self.spec_commit_copies} commit copies")
        if self.retrievals:
            lines.append(
                f"retrieval: {self.retrievals} queries "
                f"({self.retrieval_overlap_frac:.0%} overlapped), "
                f"chunk hit rate {self.retrieval_chunk_hit_rate:.0%} "
                f"({self.retrieval_chunk_hits}/"
                f"{self.retrieval_chunk_blocks} blocks)")
        if (self.preemptions or self.restores or self.cancelled
                or self.watchdog_events):
            lines.append(
                f"robustness: {self.preemptions} preemptions "
                f"({self.spilled_blocks} blocks spilled), "
                f"{self.restores} restores, {self.unstaged} unstaged, "
                f"{self.cancelled} cancelled, "
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

    def __init__(self, cfg: ModelConfig, params, *, mesh=None,
                 device=None, num_slots: int = 4, max_len: int = 256,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 segment: int = 8, admit_batch: int = 2,
                 scheduling: str = "edf",
                 faults: FaultInjector | None = None,
                 plan: LayerPlan | ExecutionPlan | ExecutionMode | str |
                 None = None) -> None:
        if scheduling not in ("edf", "fifo"):
            raise ValueError(
                f"scheduling must be 'edf' or 'fifo', got {scheduling!r}")
        if cfg.family not in _SUPPORTED_FAMILIES:
            raise ValueError(
                f"continuous batching supports families {_SUPPORTED_FAMILIES}"
                f", got {cfg.family!r} (encoder-memory families need "
                "per-request memory plumbing)")
        self.device = server_device(device, mesh)
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
        # mesh => tensor-parallel serving: every program below runs on
        # this rank's shard of the params and of the slot cache / pool
        self.tp = (make_tp_spec(cfg, self.api, mesh) if mesh is not None
                   else None)
        # folded into EVERY executable-cache key by _compiled: a server
        # on another mesh (or none) never reuses a program
        self._mesh_key = self.tp.mesh_key if self.tp is not None else None
        if self.tp is not None:
            self.params = self.tp.place_params(params)
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
        # "edf": (priority, deadline, arrival); "fifo": arrival only
        self.scheduling = scheduling
        self.faults = faults
        self._seq = 0
        self._clock = time.monotonic       # injectable (deterministic tests)
        self._timer = time.perf_counter
        self.watchdog = SegmentWatchdog()
        self._init_kv()

    def _init_kv(self) -> None:
        """The slot cache (hook: the paged subclass builds its pool)."""
        self.axes = probe_batch_axes(self.api, self.cfg, self.max_len)
        self.cache = self.api.init_cache(self.cfg, self.num_slots,
                                         self.max_len, device=self.device)
        if self.tp is not None:
            # KV heads on the model axis; everything else replicates
            self.cache = self.tp.place_cache(self.cache)

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
        a recorded compile, a known one a hit. The (mesh shape, axis
        names) tail means a server rebuilt on another mesh never replays
        a program of this one."""
        key = key + (self._mesh_key,)
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
               sample: SamplingParams | None = None, *,
               priority: int = 0, ttft_target: float | None = None,
               itl_target: float | None = None) -> int:
        """Enqueue a request; returns its rid. ``sample=None`` decodes
        greedy; a ``SamplingParams`` gives the request its own
        temperature / truncation / seed. ``priority`` ranks it under
        EDF (higher first); ``ttft_target`` (seconds) sets its deadline
        (submit time + target), ``itl_target`` is recorded. Without a
        target a request is best-effort behind every deadline."""
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
        self.pending.append(_Request(
            rid, prompt, int(max_new_tokens), sample,
            priority=int(priority), ttft_target=ttft_target,
            itl_target=itl_target, submit_t=self._clock(), seq=self._seq))
        self._seq += 1
        return rid

    def _score(self, req: _Request) -> tuple:
        """Scheduling order, smaller = sooner. EDF: priority class first
        (higher wins), the earliest deadline inside a class, arrival as
        the strict tie-break. FIFO: arrival only."""
        if self.scheduling == "fifo":
            return (req.seq,)
        return (-req.priority, req.deadline, req.seq)

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
        prefill_step = make_prefill_step(self.cfg, self.api,
                                         tp=self.tp)
        serve_step = make_serve_step(self.cfg, self.api, tp=self.tp)
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
        step = make_serve_step(self.cfg, self.api, tp=self.tp)
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


_rag_io_pool: concurrent.futures.ThreadPoolExecutor | None = None


def _rag_io() -> concurrent.futures.ThreadPoolExecutor:
    """The shared retrieval worker: ONE thread, so queries retrieve in
    submission order. ``RagPipeline.retrieve`` is a pure function of the
    query over a read-only index, so running it here moves only its wall
    time off the dispatch thread (its modeled fetch sleeps and numpy
    release the GIL)."""
    global _rag_io_pool
    if _rag_io_pool is None:
        _rag_io_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rag-io")
    return _rag_io_pool


@dataclasses.dataclass(eq=False)
class _PendingQuery:
    """A RAG query waiting for its retrieval: a ``_Request`` without its
    prompt, which retrieval and assembly make. ``seq`` is taken at
    submit, so retrieval latency never reorders a query behind later
    plain submits."""

    rid: int
    query: np.ndarray
    max_new: int
    sample: SamplingParams | None
    priority: int
    ttft_target: float | None
    itl_target: float | None
    submit_t: float
    seq: int


@dataclasses.dataclass(eq=False)
class _Spilled:
    """A preempted request waiting to resume: its generated tokens on
    the host, its KV payload in the spill region (keyed by rid). It
    holds no pool block."""

    req: _Request
    generated: int
    tokens: np.ndarray        # (generated,) int32
    valid_end: int            # KV valid on [0, valid_end) at restore
    n_blocks: int
    first_t: float | None     # the first token's time (TTFT keeps it)


@dataclasses.dataclass(eq=False)
class _Staging:
    """A request whose prompt KV is being staged into the pool, or a
    restored spill (``resume``) whose KV is already in place; ``todo``
    holds the position spans still to prefill, in order."""

    req: _Request
    rb: kvp.RequestBlocks
    todo: list[list[int]]
    resume: _Spilled | None = None

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
    ``spec`` (a ``SpecConfig``; ``k == 0`` or None: plain segments) and
    ``rag`` (a ``RagPipeline`` of this block size) / ``rag_overlap``:
    see the module docstring.
    """

    def __init__(self, cfg: ModelConfig, params, *, block_size: int = 16,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 stage_ahead: int | None = None,
                 spill_region: SidebarSpillRegion | None = None,
                 kernel: str = "paged",
                 stage_capture_after: int = STAGE_CAPTURE_AFTER,
                 spec: SpecConfig | None = None,
                 rag=None, rag_overlap: bool = True, **kw) -> None:
        if kernel not in ("paged", "slab"):
            raise ValueError(f"kernel must be 'paged' or 'slab', got "
                             f"{kernel!r}")
        self.spec = spec
        self._spec_on = spec is not None and spec.k > 0
        if self._spec_on:
            spec.validate(cfg)
        if rag is not None and rag.block_size != int(block_size):
            raise ValueError(
                f"RagPipeline block_size {rag.block_size} != scheduler "
                f"block_size {block_size}: chunk boundaries must land on "
                "pool block boundaries")
        self.rag = rag
        self.rag_overlap = bool(rag_overlap)
        self._queries: collections.deque[_PendingQuery] = (
            collections.deque())
        self._rag_futures: dict[int, concurrent.futures.Future] = {}
        self._rag_meta: dict[int, list[int]] = {}   # rid -> chunk blocks
        self.rag_results: dict[int, Any] = {}       # rid -> RagPrompt
        self.kernel = kernel
        self.block_size = int(block_size)
        self._num_blocks_arg = num_blocks
        self.prefill_chunk = int(prefill_chunk or block_size)
        self._stage_ahead_arg = stage_ahead
        self.stage_capture_after = int(stage_capture_after)
        self._spill_region_arg = spill_region
        if self._spec_on and kw.get("mesh") is not None:
            raise NotImplementedError(
                "the speculative verify step under a mesh is not ported "
                "(ROADMAP Queue 1 item 6)")
        super().__init__(cfg, params, **kw)
        self._prefill_step = make_prefill_step(self.cfg, self.api,
                                               tp=self.tp)
        if self.faults is not None:
            # the allocation-failure site: every alloc consults it
            self.mgr.alloc.fault_hook = lambda: self.faults.fire("alloc")

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
        # speculative decoding: each slot owns a private slice of spare
        # pool rows (outside the allocator) for the worst drafted
        # overhang, k positions past a block-aligned frontier
        spec_k = self.spec.k if self._spec_on else 0
        self._n_scratch = -(-spec_k // self.block_size)
        self.mgr = kvp.PagedKVManager(
            self.api, self.cfg, num_blocks=nb, block_size=self.block_size,
            device=self.device,
            place=self.tp.place_cache if self.tp is not None else None,
            spare_blocks=self.num_slots * self._n_scratch)
        if self._spec_on:
            spare = list(self.mgr.spare_ids)
            n = self._n_scratch
            self._scratch = [spare[i * n:(i + 1) * n]
                             for i in range(self.num_slots)]
            self.draft_api = self.spec.draft_api()
            self._draft_params = self.spec.draft_params
            # the draft's own dense slot cache: it never takes pool
            # blocks, and the programs write it in place
            self._draft_cache = self.draft_api.init_cache(
                self.spec.draft_cfg, self.num_slots, self.max_len,
                device=self.device)
            # slot -> (rid, draft ingest frontier); keyed by rid, so slot
            # reuse, spill and restore reset the frontier
            self._dpos: dict[int, tuple[int, int]] = {}
        self.cache = None  # the pool replaces the slab entirely
        self.stage_ahead = (self._stage_ahead_arg
                            if self._stage_ahead_arg is not None
                            else self.num_slots)
        self._tables = np.full((self.num_slots, self.blocks_per_table),
                               kvp.SCRATCH_BLOCK, np.int32)
        self._slot_rb: list[kvp.RequestBlocks | None] = (
            [None] * self.num_slots)
        self._staging: collections.deque[_Staging] = collections.deque()
        # preempted requests; their payloads live in the spill region,
        # keyed by rid (an empty region is falsy: test against None)
        self.spill = (self._spill_region_arg
                      if self._spill_region_arg is not None
                      else SidebarSpillRegion())
        self._spilled: list[_Spilled] = []
        # slot -> correction token of rows admitted this boundary (a
        # row spilled before the dispatch drops its entry)
        self._admit_pending: dict[int, int] = {}
        self.stats.pool_blocks = self.mgr.alloc.capacity

    def _validated(self, tables: np.ndarray) -> torch.Tensor:
        """Bounds-check a table batch on the host (against the pool's
        physical rows: the spare scratch rows are legal), then ship it."""
        kvp.validate_tables(tables, self.mgr.pool.num_blocks)
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
        return (super()._has_work() or bool(self._staging)
                or bool(self._spilled) or bool(self._queries))

    @property
    def load(self) -> int:
        return (super().load + len(self._staging) + len(self._spilled)
                + len(self._queries))

    def submit(self, prompt, max_new_tokens: int,
               sample: SamplingParams | None = None, *,
               priority: int = 0, ttft_target: float | None = None,
               itl_target: float | None = None) -> int:
        prompt_arr = np.asarray(prompt, np.int32).reshape(-1)
        if prompt_arr.size >= 1 and max_new_tokens >= 1:
            # allocation is lazy, but the worst-case span must fit the
            # pool alone, or the request could preempt everything and
            # still wedge
            need = self.mgr.blocks_needed(
                prompt_arr.size + max_new_tokens - 1)
            if need > self.mgr.alloc.capacity:
                raise ValueError(
                    f"request needs {need} blocks, pool holds "
                    f"{self.mgr.alloc.capacity} — raise num_blocks or "
                    "shrink the request")
        return super().submit(prompt, max_new_tokens, sample,
                              priority=priority, ttft_target=ttft_target,
                              itl_target=itl_target)

    # -- retrieval (RAG) ----------------------------------------------------
    def submit_query(self, query, max_new_tokens: int,
                     sample: SamplingParams | None = None, *,
                     priority: int = 0, ttft_target: float | None = None,
                     itl_target: float | None = None) -> int:
        """Enqueue a RAG query; returns its rid. Retrieval and assembly
        run later, between dispatches; the assembled ``RagPrompt`` lands
        in ``rag_results[rid]`` and its tokens take the submit path. The
        assembled length is known before retrieval (system prefix and
        top_k chunks are fixed-size), so a request that cannot fit
        raises here."""
        if self.rag is None:
            raise ValueError(
                "submit_query needs a RagPipeline: construct the server "
                "with rag=RagPipeline(...)")
        q = np.asarray(query, np.int32).reshape(-1)
        if q.size < 1:
            raise ValueError("empty query")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        s = self.rag.prompt_len_for + q.size
        if s + max_new_tokens > self.max_len:
            raise ValueError(
                f"assembled prompt {s} + max_new {max_new_tokens} "
                f"exceeds max_len {self.max_len}")
        need = self.mgr.blocks_needed(s + max_new_tokens - 1)
        if need > self.mgr.alloc.capacity:
            raise ValueError(
                f"assembled request needs {need} blocks, pool holds "
                f"{self.mgr.alloc.capacity} — raise num_blocks or "
                "shrink the request")
        rid = self._next_rid
        self._next_rid += 1
        self._queries.append(_PendingQuery(
            rid=rid, query=q, max_new=int(max_new_tokens), sample=sample,
            priority=int(priority), ttft_target=ttft_target,
            itl_target=itl_target, submit_t=self._clock(), seq=self._seq))
        self._seq += 1
        if self.rag_overlap:
            # the search starts now on the worker and runs behind every
            # host step and dispatch until the drain collects it
            self._rag_futures[rid] = _rag_io().submit(self.rag.retrieve, q)
        return rid

    def _drain_queries(self, *, overlapped: bool) -> None:
        """Collect every parked query's retrieval (or run it, without
        overlap), assemble it and make it a pending request. Called right
        after a dispatch (``overlapped``: the search ran behind it) or at
        the top of ``_advance`` when nothing decodes or overlap is off."""
        while self._queries:
            pq = self._queries.popleft()
            fut = self._rag_futures.pop(pq.rid, None)
            rp = self.rag.assemble(
                pq.query, ranked=None if fut is None else fut.result())
            self.rag_results[pq.rid] = rp
            self._rag_meta[pq.rid] = rp.chunk_blocks(self.block_size)
            self.stats.retrievals += 1
            if overlapped:
                self.stats.retrieval_overlapped += 1
            self.pending.append(_Request(
                pq.rid, rp.tokens, pq.max_new, pq.sample,
                priority=pq.priority, ttft_target=pq.ttft_target,
                itl_target=pq.itl_target, submit_t=pq.submit_t,
                seq=pq.seq))

    def cancel(self, rid: int) -> bool:
        for pq in self._queries:
            if pq.rid == rid:
                # an in-flight search is pure: drop its handle
                self._queries.remove(pq)
                self._rag_futures.pop(rid, None)
                self.stats.cancelled += 1
                return True
        for st in self._staging:
            if st.req.rid == rid:
                self._staging.remove(st)
                self.mgr.release_request(st.rb)
                self.stats.cancelled += 1
                return True
        for sp in self._spilled:
            if sp.req.rid == rid:
                self._spilled.remove(sp)
                self.spill.release(rid)
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
        """Restore spilled requests (they are furthest along), start
        staging the best-scored pending requests (prefix splice + the
        prompt's blocks: the span grows lazily, ``_grow_active``), then
        advance every incomplete entry by one chunk round — or to
        completion when nothing decodes (``catch_up``). Under pool
        pressure a better-scored request reclaims from strictly worse
        holders (``_reclaim_for``); a full staging queue yields its
        worst entry to a strictly better one (the EDF jump)."""
        self._try_restore()
        while self.pending:
            req = min(self.pending, key=self._score)
            if len(self._staging) >= self.stage_ahead:
                worst = max(self._staging,
                            key=lambda st: self._score(st.req))
                if not self._score(req) < self._score(worst.req):
                    break
                self._unstage(worst)
            n_stage = max(int(req.prompt.size) - 1, 1)
            rb = self.mgr.begin_request(req.prompt, n_stage)
            while rb is None and self._reclaim_for(self._score(req)):
                rb = self.mgr.begin_request(req.prompt, n_stage)
            if rb is None:
                self.stats.stage_stalls += 1
                break
            self.pending.remove(req)
            meta = self._rag_meta.pop(req.rid, None)
            if meta is not None:
                # chunk reuse: of the retrieved-chunk blocks this prompt
                # stages, those spliced from the index
                self.stats.retrieval_chunk_blocks += len(meta)
                self.stats.retrieval_chunk_hits += len(
                    set(rb.hit_idx) & set(meta))
            self._staging.append(_Staging(
                req=req, rb=rb,
                todo=_hole_spans(rb.hit_idx, int(req.prompt.size) - 1,
                                 self.block_size)))
        if self.faults is not None and self.faults.fire("stage_stall"):
            # an injected wedged round: no prefill this boundary
            self.stats.stage_stalls += 1
            return
        while True:
            work = [st for st in self._staging if not st.done]
            if not work:
                return
            self._stage_round(work)
            if not catch_up:
                return

    # -- preemption: spill / restore / reclaim -----------------------------
    def _spill_payload(self, rid: int, rb: kvp.RequestBlocks,
                       valid_end: int) -> int:
        """Copy ``rb``'s first ``valid_end`` positions of KV to the
        spill region under ``rid`` and release its blocks; returns the
        blocks spilled."""
        payload = self.mgr.spill_request(rb, valid_end)
        self.spill.stage(rid)
        self.spill.commit(rid, payload, payload["nbytes"])
        self.stats.preemptions += 1
        self.stats.spilled_blocks += payload["n_blocks"]
        return payload["n_blocks"]

    def _spill_slot(self, i: int) -> None:
        """Preempt the request in slot ``i`` at a segment boundary: sync
        its generated tokens, spill its KV, free the slot. Restore
        resumes it position-exact (the PRNG is keyed by position)."""
        slot = self.slots[i]
        tokens = self.slot_tokens(i)
        n = self._spill_payload(slot.rid, self._slot_rb[i], slot.pos)
        self._spilled.append(_Spilled(
            req=slot.req, generated=slot.generated, tokens=tokens,
            valid_end=slot.pos, n_blocks=n, first_t=slot.first_t))
        self._slot_rb[i] = None
        self._tables[i] = kvp.SCRATCH_BLOCK
        self._admit_pending.pop(i, None)   # dies with the slot
        self.slots[i] = _Slot()

    def _unstage(self, st: _Staging) -> None:
        """Reclaim a staging entry's blocks: a fresh entry goes back to
        pending (its prompt KV is recomputable), a restored spill is
        spilled again (its generated KV is not)."""
        self._staging.remove(st)
        if st.resume is None:
            self.mgr.release_request(st.rb)
            self.pending.append(st.req)
            self.stats.unstaged += 1
        else:
            sp = st.resume
            self._spill_payload(sp.req.rid, st.rb, sp.valid_end)
            self._spilled.append(sp)

    def _reclaim_for(self, score: tuple,
                     exclude_slot: int | None = None) -> bool:
        """Free pool blocks for a request scoring ``score`` from the
        worst strictly worse holder: a staging entry is unstaged, an
        active slot spilled. False when none is worse (scores are a
        strict total order, so A can preempt B and never B A)."""
        victims: list[tuple[tuple, int, object]] = []
        for st in self._staging:
            victims.append((self._score(st.req), 0, st))
        for i, slot in enumerate(self.slots):
            if i != exclude_slot and not slot.free:
                victims.append((self._score(slot.req), 1, i))
        victims = [v for v in victims if v[0] > score]
        if not victims:
            return False
        _, kind, victim = max(victims, key=lambda v: v[0])
        if kind == 0:
            self._unstage(victim)
        else:
            self._spill_slot(victim)
        return True

    def _try_restore(self) -> None:
        """Splice spilled requests back, best score first, one per free
        slot: blocks re-acquired (index hits spliced, the rest written
        from the host copy), then the staged-done queue — admission
        treats a restore like a fully staged arrival. On failure the
        request stays spilled, its payload untouched."""
        if not self._spilled:
            return
        reserved = 0   # restores this call, each owed a free slot
        for sp in sorted(self._spilled, key=lambda s: self._score(s.req)):
            if sum(s.free for s in self.slots) - reserved <= 0:
                return
            payload = self.spill.fetch(sp.req.rid)
            rb = self.mgr.restore_request(sp.req.prompt, payload)
            while rb is None and self._reclaim_for(self._score(sp.req)):
                rb = self.mgr.restore_request(sp.req.prompt, payload)
            if rb is None:
                return
            self._spilled.remove(sp)
            self.spill.release(sp.req.rid)
            self._staging.append(_Staging(req=sp.req, rb=rb, todo=[],
                                          resume=sp))
            self.stats.restores += 1
            self.stats.restored_blocks += sp.n_blocks

    # -- work-stealing handoff (the replica router) -------------------------
    def take_spilled(self, rid: int) -> tuple[_Spilled, dict] | None:
        """Detach a spilled request for a sibling replica: its resume
        state and host payload (CPU tensors), its region entry
        released."""
        for sp in self._spilled:
            if sp.req.rid == rid:
                self._spilled.remove(sp)
                payload = self.spill.fetch(rid)
                self.spill.release(rid)
                return sp, payload
        return None

    def submit_spilled(self, sp: _Spilled, payload: dict) -> int:
        """Adopt a request stolen from a sibling under a new local rid
        and arrival index (priority, deadline and first-token time
        travel with it) and park it in the local spill region; the
        restore path does the rest."""
        rid = self._next_rid
        self._next_rid += 1
        sp.req.rid = rid
        sp.req.seq = self._seq
        self._seq += 1
        self.spill.stage(rid)
        self.spill.commit(rid, payload, payload["nbytes"])
        self._spilled.append(sp)
        return rid

    # -- admission: a block-table splice, zero dispatches ------------------
    def _admit_ready(self) -> None:
        """Move fully staged requests into free slots, best score first.
        The correction token parks in ``_admit_pending`` until the next
        segment feeds it. A restored spill re-enters at ``valid_end``
        with its synced tokens as a host chunk and its first-token
        time."""
        ready = sorted((st for st in self._staging if st.done),
                       key=lambda st: self._score(st.req))
        free = [i for i, s in enumerate(self.slots) if s.free]
        for st in ready:
            if not free:
                return
            i = free.pop(0)
            self._staging.remove(st)
            r, sp = st.req, st.resume
            key = (None if r.sample is None
                   else sampling.request_key(r.sample.seed))
            if sp is None:
                self.mgr.publish_prompt(r.prompt, st.rb)
                # the first write position S-1 must be exclusively
                # owned; structurally it always is — enforced, not
                # assumed
                wb = (int(r.prompt.size) - 1) // self.block_size
                if wb < len(st.rb.bids):
                    self.mgr.ensure_exclusive(st.rb, wb)
                self.slots[i] = _Slot(
                    rid=r.rid, pos=int(r.prompt.size) - 1,
                    remaining=r.max_new, prompt=r.prompt, sample=r.sample,
                    key=key, req=r)
                tok = int(r.prompt[-1])
                self.stats.admitted += 1
            else:
                # resume where the stream left off: the next input is
                # the last generated token (prompt[-1] if none)
                chunks = ([(torch.from_numpy(sp.tokens.reshape(1, -1)), 0,
                            sp.generated)] if sp.generated else [])
                self.slots[i] = _Slot(
                    rid=r.rid, pos=sp.valid_end,
                    remaining=r.max_new - sp.generated,
                    generated=sp.generated, chunks=chunks, prompt=r.prompt,
                    sample=r.sample, key=key, req=r, first_t=sp.first_t)
                tok = (int(sp.tokens[-1]) if sp.generated
                       else int(r.prompt[-1]))
            self._tables[i] = st.rb.table_row(self.blocks_per_table)
            self._slot_rb[i] = st.rb
            self._admit_pending[i] = tok

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
        capped at ``segment`` while staging needs boundaries, a parked
        query will stage at the next one, or a live submit could enter a
        free slot; above ``segment`` the length rounds down to a power of
        two."""
        min_rem = min(self.slots[i].remaining for i in active)
        staging_wants_boundaries = (
            any(not st.done for st in self._staging)
            or bool(self._spilled)    # spills restore only at boundaries
            or bool(self._queries))   # park -> retrieve -> stage next
        entry_possible = staging_wants_boundaries or (
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
        step = make_serve_step(self.cfg, self.api, tp=self.tp)
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
        step = make_serve_step(self.cfg, self.api, tp=self.tp)
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

    def _grow_active(self, draining: bool,
                     steps_override: int | None = None
                     ) -> tuple[list[int], int]:
        """Grow every active row's span to cover the coming segment
        (``pos + steps``), best-scored rows first. A row that cannot
        grow reclaims from strictly worse holders, and when none exists
        spills itself. Any change of membership restarts the pass, so
        the returned (active, steps) is a fixpoint: every listed row
        owns its segment's span. ``steps_override`` fixes the span
        target: the speculative path secures one position (its input
        token's write); drafted positions go to scratch."""
        while True:
            active = [i for i, s in enumerate(self.slots)
                      if not s.free and s.remaining > 0]
            if not active:
                return [], 0
            steps = (steps_override if steps_override is not None
                     else self._segment_steps(active, draining=draining))
            changed = False
            for i in sorted(active,
                            key=lambda j: self._score(self.slots[j].req)):
                slot = self.slots[i]
                if slot.free:       # spilled by an earlier row's growth
                    changed = True
                    continue
                rb = self._slot_rb[i]
                need = slot.pos + steps
                ok = self.mgr.ensure_span(rb, need)
                while not ok and self._reclaim_for(
                        self._score(slot.req), exclude_slot=i):
                    changed = True
                    ok = self.mgr.ensure_span(rb, need)
                if not ok:
                    self._spill_slot(i)
                    changed = True
            if not changed:
                return active, steps

    def _advance(self, *, draining: bool = False) -> None:
        if self.faults is not None and self.faults.fire("evict_storm"):
            # an injected eviction storm: every cached block evicted,
            # the prefix index flushed
            self.mgr.alloc.evict_cached()
        active_now = any(not s.free and s.remaining > 0 for s in self.slots)
        if self._queries and not (self.rag_overlap and active_now):
            # nothing decodes to hide behind, or overlap is off: collect
            # now, so the queries stage at this boundary
            if not self.rag_overlap and self.device.type == "cuda":
                # serial means serial: the queued device work finishes
                # before retrieval, which would otherwise hide behind it
                torch.cuda.synchronize(self.device)
            self._drain_queries(overlapped=False)
        self._stage(catch_up=not active_now)
        self._admit_ready()
        self._sync_pool_stats()
        if self._spec_on:
            self._advance_spec(draining)
            return
        active, steps = self._grow_active(draining)
        if not active:
            return
        for i in active:
            # growth may have extended a span: refresh its table row
            # (entries past the span stay on the scratch block)
            self._tables[i] = self._slot_rb[i].table_row(
                self.blocks_per_table)
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
        if self._queries:
            # the searches ran on the worker behind the dispatch above;
            # collect them before the host first reads its tokens
            self._drain_queries(overlapped=True)
        self._account(active, steps, buf)
        self._sync_pool_stats()

    # -- speculative decoding (launch.spec) --------------------------------
    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A program's result read on the host: a speculative step's two
        syncs (the drafts before the verify, the targets after it)."""
        return t.cpu().numpy()

    def _hist(self, i: int) -> np.ndarray:
        """Committed history of the request in slot ``i`` (prompt and
        accepted tokens): ``hist[p]`` is the token at index p, so
        ``hist[slot.pos]`` is the verifier's input token."""
        slot = self.slots[i]
        return np.concatenate(
            [slot.prompt, self.slot_tokens(i)]).astype(np.int32)

    def _draft_fn(self) -> Callable:
        """The draft program on the draft's params and slot cache. It runs
        under the default plan: a per-layer plan names the target's
        layers."""
        draft = make_draft_program(self.spec.draft_cfg, self.draft_api,
                                   self.spec.k, self.max_len)

        def run(fixed, chunk, chunk_len, start):
            params, cache = fixed
            return draft(params, chunk, chunk_len, start, cache)

        return run

    def _verify_fn(self) -> Callable:
        """The verify program, in place on the pool."""
        verify = make_verify_step(self.cfg, self.api)

        def run(fixed, tokens, pos, tables, sample):
            params, pool = fixed
            return verify(params, tokens, pool, pos, tables, sample)

        return run

    def _draft_tokens(self, active: list[int]) -> np.ndarray:
        """Run the ingest-and-draft program; returns the (N, k) drafts.

        Each round feeds every active row the next <= k + 1 committed
        tokens past its draft frontier (``_dpos``). In steady state the
        lag is the last commit (<= k + 1), so one round ingests and
        drafts; after admission or a restore, catch-up rounds run until
        every frontier reaches ``pos + 1``. A row already caught up
        re-feeds its input token at ``pos`` (the same KV rewritten), so
        the batch keeps its shape. Only the final round's drafts are
        read."""
        k = self.spec.k
        w = k + 1
        n = self.num_slots
        max_pos = self.max_len - 1
        hists = {i: self._hist(i) for i in active}
        dpos = {}
        for i in active:
            rid, dp = self._dpos.get(i, (None, 0))
            dpos[i] = dp if rid == self.slots[i].rid else 0
        fn = self._compiled(("draft", n, k),
                            lambda: self._program(self._draft_fn()))
        while True:
            chunk = np.zeros((n, w), np.int64)
            clen = np.ones((n,), np.int64)
            start = np.full((n,), max_pos, np.int64)
            final = True
            for i in active:
                pos = self.slots[i].pos
                lag = pos + 1 - dpos[i]
                if lag <= 0:
                    start[i] = pos
                    chunk[i, 0] = hists[i][pos]
                else:
                    take = min(lag, w)
                    start[i] = dpos[i]
                    chunk[i, :take] = hists[i][dpos[i]:dpos[i] + take]
                    clen[i] = take
                    dpos[i] += take
                    if dpos[i] < pos + 1:
                        final = False
            drafts = fn((self._draft_params, self._draft_cache),
                        chunk=torch.as_tensor(chunk, device=self.device),
                        chunk_len=torch.as_tensor(clen, device=self.device),
                        start=torch.as_tensor(start, device=self.device))
            if final:
                break
        for i in active:
            self._dpos[i] = (self.slots[i].rid, dpos[i])
        return self._fetch(drafts)

    def _advance_spec(self, draining: bool) -> None:
        """One speculative iteration: draft k, verify k + 1 in one
        program, accept and commit on the host. The pool grows only by
        accepted positions: the verifier writes drafted positions into
        the slot's spare rows (spliced into its table past the span), and
        the commit copies just the blocks the accepted span reaches into
        allocator-owned blocks, in place (``KVPool.copy_blocks``)."""
        k = self.spec.k
        n = self.num_slots
        active, _ = self._grow_active(draining, steps_override=1)
        if not active:
            return
        # an admitted row's input token comes from its host history here
        self._admit_pending.clear()
        drafts = self._draft_tokens(active)
        width = self._segment_table_width(active, k + 1)
        bt = np.full((n, width), kvp.SCRATCH_BLOCK, np.int32)
        toks = np.zeros((n, k + 1), np.int64)
        pos = np.full((n,), self.max_len - 1, np.int64)
        for i in active:
            slot = self.slots[i]
            rb = self._slot_rb[i]
            row = rb.table_row(self.blocks_per_table)[:width].copy()
            # drafted positions past the span land in this slot's
            # private spare rows
            need = min(self.mgr.blocks_needed(slot.pos + k + 1), width)
            for j in range(len(rb.bids), need):
                row[j] = self._scratch[i][j - len(rb.bids)]
            bt[i] = row
            toks[i, 0] = self._hist(i)[slot.pos]
            toks[i, 1:] = drafts[i]
            pos[i] = slot.pos
        # no check_span by design: drafted writes pass the span into
        # scratch; the tables are still bounds-checked
        state = self._segment_sample_state(active)
        vf = self._compiled(
            ("specv", n, k, width,
             "sampled" if state is not None else "greedy", self._plan_key),
            lambda: self._program(self._verify_fn()))
        t0 = self._timer()
        with kops.execution_plan(self.plan):
            tgt = vf((self.params, self.mgr.pool.cache),
                     tokens=torch.as_tensor(toks, device=self.device),
                     pos=torch.as_tensor(pos, device=self.device),
                     tables=self._validated(bt), sample=state)
        if self._queries:
            # the searches ran behind the verify dispatch: collect them
            # before the host reads its targets
            self._drain_queries(overlapped=True)
        # the accept policy is the host's: read the targets
        tgt = self._fetch(tgt)
        self._observe(t0)
        tgt_rows = torch.from_numpy(tgt)
        self.stats.segments += 1
        self.stats.spec_steps += 1
        rids = {i: self.slots[i].rid for i in active}
        wasted = (k + 1) * (n - len(active))
        now = self._clock()
        for i in sorted(active, key=lambda j: self._score(self.slots[j].req)):
            slot = self.slots[i]
            if slot.free or slot.rid != rids[i]:
                # spilled by a better row's commit growth: its round is
                # discarded, and redone after the restore
                wasted += k + 1
                continue
            m = accepted_prefix(drafts[i], tgt[i])
            emit = min(m + 1, slot.remaining)
            self.stats.spec_drafted += k
            self.stats.spec_accepted += m
            rb = self._slot_rb[i]
            old_nb = len(rb.bids)
            ok = self.mgr.ensure_span(rb, slot.pos + emit)
            while not ok and self._reclaim_for(self._score(slot.req),
                                               exclude_slot=i):
                ok = self.mgr.ensure_span(rb, slot.pos + emit)
            if not ok:
                # the pool cannot hold the accepted span: keep what the
                # span already covers (>= 1 token, secured above)
                emit = max(1, min(emit, rb.span - slot.pos))
            new_nb = len(rb.bids)
            if new_nb > old_nb:
                dst = rb.bids[old_nb:new_nb]
                self.mgr.pool.copy_blocks(dst, self._scratch[i][:len(dst)])
                kops.record_dispatch("spec_commit_copy", "dma")
                self.stats.spec_commit_copies += len(dst)
            self.stats.decode_steps += emit
            wasted += (k + 1) - emit
            slot.chunks.append((tgt_rows, i, emit))
            slot.generated += emit
            slot.remaining -= emit
            slot.pos += emit
            if slot.first_t is None:
                slot.first_t = now
                if slot.req is not None:
                    self.stats.record_ttft(slot.req.priority,
                                           now - slot.req.submit_t)
            if slot.remaining == 0:
                self._retire(i)
        self.stats.wasted_steps += wasted
        self._sync_pool_stats()


__all__ = ["ContinuousBatchingServer", "DEFAULT_BUCKETS", "FinishedRequest",
           "PagedContinuousBatchingServer", "SchedulerStats",
           "probe_batch_axes"]
