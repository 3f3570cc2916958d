"""Paged KV pool: block allocator with prefix caching, and the device
pool as torch tensors (mirror of ``repro.launch.kvpool``).

The host side — ``BlockAllocator`` (free list, refcounts, explicit
``free -> staged -> active (+ cached)`` lifecycle, hash-consed prefix
index with LRU eviction), the prefix/chunk keys, ``validate_tables``,
``RequestBlocks`` and ``PagedKVManager`` — is ported close to verbatim.
Left out with the features that use them: spill/restore (preemption),
spare scratch rows (speculative decoding), affinity probes (the router)
and the fault hook.

Device side, ``KVPool`` holds the model's own per-layer cache at
``batch = num_blocks + 1`` and ``max_len = block_size``: every leaf has
its block axis first, and its position axis where the family keeps it
(GQA k, v: (P+1, Hkv, bs, Dh) and int8 scales (P+1, Hkv, bs): axis 2;
MLA c_kv, k_rope: (P+1, bs, r): axis 1). ``length_axes`` finds each
leaf's position axis from the model's cache shapes, as the JAX package's
``probe_length_axes`` does, so ``gather_blocks``, ``scatter_blocks`` and
``copy_blocks`` serve every family. The extra row P is the drop sink of
out-of-table writes (``models.attention``); no table names it.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import hashlib

import numpy as np
import torch

from repro_torch.kernels import ops as kops

# Block 0 is the reserved scratch block: free slots' block tables and the
# padded tail of every table point at it, so dead writes land in junk
# that no unmasked read ever sees.
SCRATCH_BLOCK = 0


class KVPoolError(RuntimeError):
    """Violation of the block lifecycle / refcount protocol."""


class BlockState(enum.Enum):
    FREE = "free"        # on the free list, content meaningless
    STAGED = "staged"    # allocated; prefill-ahead is writing its KV
    ACTIVE = "active"    # owned (refcount >= 1) by live request(s)
    CACHED = "cached"    # refcount 0 but prefix-indexed; LRU-evictable


def prefix_key(tokens: np.ndarray, end: int) -> bytes:
    """Content key of the prefix ``tokens[:end]`` (byte-exact)."""
    return np.ascontiguousarray(tokens[:end], dtype=np.int32).tobytes()


def chunk_key(prev: bytes, tokens: np.ndarray) -> bytes:
    """Chained chunk-boundary key ``H(prev_key || block_tokens)``: the
    same content as the whole-prefix key in O(1) bytes per block."""
    h = hashlib.sha256(prev)
    h.update(np.ascontiguousarray(tokens, dtype=np.int32).tobytes())
    return b"ck:" + h.digest()


def chunk_keys(tokens: np.ndarray, n_blocks: int,
               block_size: int) -> list[bytes]:
    """Chunk-boundary keys of the first ``n_blocks`` full blocks."""
    t = np.asarray(tokens, np.int32).reshape(-1)
    keys: list[bytes] = []
    prev = b""
    for j in range(n_blocks):
        prev = chunk_key(prev, t[j * block_size:(j + 1) * block_size])
        keys.append(prev)
    return keys


@dataclasses.dataclass
class PoolCounters:
    """Allocator-level counters surfaced into ``SchedulerStats``."""

    allocs: int = 0
    evictions: int = 0
    cow_copies: int = 0
    prefix_block_lookups: int = 0
    prefix_block_hits: int = 0
    prompt_blocks: int = 0          # full prompt[:-1] blocks walked
    chunk_interior_hits: int = 0    # splices past the first miss
    in_use_peak: int = 0


class BlockAllocator:
    """Host-side block lifecycle: free list, refcounts, prefix index.
    ``num_blocks`` includes the reserved scratch block 0."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is the scratch)")
        self.num_blocks = int(num_blocks)
        self._state = [BlockState.FREE] * num_blocks
        self._ref = [0] * num_blocks
        self._state[SCRATCH_BLOCK] = BlockState.ACTIVE  # never handed out
        self._ref[SCRATCH_BLOCK] = 1
        self._free: collections.deque[int] = collections.deque(
            range(1, num_blocks))
        self._evictable: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())
        self._index: dict[bytes, int] = {}
        self._keys_of: dict[int, list[bytes]] = {}
        self.counters = PoolCounters()

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_evictable(self) -> int:
        return len(self._evictable)

    @property
    def in_use(self) -> int:
        return self.capacity - self.num_free - self.num_evictable

    def state(self, bid: int) -> BlockState:
        return self._state[bid]

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def _check(self, bid: int) -> None:
        if not 0 < bid < self.num_blocks:
            raise KVPoolError(f"block id {bid} out of range "
                              f"(1..{self.num_blocks - 1}; 0 is scratch)")

    def can_alloc(self, n: int) -> bool:
        return self.num_free + self.num_evictable >= n

    def alloc(self) -> int:
        """free -> staged; evicts the LRU cached block when the free list
        is dry; raises ``KVPoolError`` when nothing is left."""
        if self._free:
            bid = self._free.popleft()
        elif self._evictable:
            bid, _ = self._evictable.popitem(last=False)
            self._drop_keys(bid)
            self.counters.evictions += 1
        else:
            raise KVPoolError(
                f"KV pool exhausted: all {self.capacity} blocks are "
                "staged or active (no cached block to evict)")
        if self._ref[bid] != 0:
            raise KVPoolError(f"block {bid} on the free path with refcount "
                              f"{self._ref[bid]} (double allocation)")
        self._state[bid] = BlockState.STAGED
        self._ref[bid] = 1
        self.counters.allocs += 1
        self.counters.in_use_peak = max(self.counters.in_use_peak,
                                        self.in_use)
        return bid

    def activate(self, bid: int) -> None:
        """staged -> active."""
        self._check(bid)
        if self._state[bid] is not BlockState.STAGED:
            raise KVPoolError(f"activate on block {bid} in state "
                              f"{self._state[bid].value!r} (must be staged)")
        self._state[bid] = BlockState.ACTIVE

    def retain(self, bid: int) -> None:
        """Add an owner (a prefix hit); a cached block revives."""
        self._check(bid)
        st = self._state[bid]
        if st is BlockState.CACHED:
            self._evictable.pop(bid)
            self._state[bid] = BlockState.ACTIVE
            self._ref[bid] = 1
            self.counters.in_use_peak = max(self.counters.in_use_peak,
                                            self.in_use)
            return
        if st is not BlockState.ACTIVE:
            raise KVPoolError(f"retain on block {bid} in state {st.value!r} "
                              "(only active/cached blocks can gain owners)")
        self._ref[bid] += 1

    def release(self, bid: int) -> None:
        """Drop one owner; at refcount 0 an indexed block becomes cached,
        an unindexed one free."""
        self._check(bid)
        if self._state[bid] is BlockState.FREE or self._ref[bid] < 1:
            raise KVPoolError(
                f"release on block {bid} (state {self._state[bid].value!r}, "
                f"refcount {self._ref[bid]}): refcounts never go negative")
        self._ref[bid] -= 1
        if self._ref[bid] > 0:
            return
        if self._keys_of.get(bid):
            self._state[bid] = BlockState.CACHED
            self._evictable[bid] = None
        else:
            self._state[bid] = BlockState.FREE
            self._free.append(bid)

    def _drop_keys(self, bid: int) -> None:
        for key in self._keys_of.pop(bid, []):
            del self._index[key]

    def lookup_any(self, keys) -> int | None:
        """One counted lookup across alias keys naming the same content."""
        self.counters.prefix_block_lookups += 1
        for key in keys:
            bid = self._index.get(key)
            if bid is not None:
                self.counters.prefix_block_hits += 1
                return bid
        return None

    def is_registered(self, bid: int) -> bool:
        return bool(self._keys_of.get(bid))

    def register(self, key: bytes, bid: int) -> int:
        """Hash-cons ``bid`` under ``key``; an existing owner of the key
        wins. Returns the canonical id."""
        self._check(bid)
        if self._state[bid] is not BlockState.ACTIVE:
            raise KVPoolError(f"register on block {bid} in state "
                              f"{self._state[bid].value!r} (must be active)")
        existing = self._index.get(key)
        if existing is not None:
            return existing
        self._index[key] = bid
        self._keys_of.setdefault(bid, []).append(key)
        return bid


# ---------------------------------------------------------------------------
# Device pool
# ---------------------------------------------------------------------------


def length_axes(api, cfg) -> list[dict[str, int]]:
    """Each cache leaf's position (length) axis, per layer: the axis
    whose extent follows ``max_len`` in the model's cache shapes
    (``probe_length_axes`` of the JAX package)."""
    def axis(a, b):
        diff = [i for i, (x, y) in enumerate(zip(a[0], b[0])) if x != y]
        if len(diff) != 1:
            raise ValueError(f"cannot find the length axis of {a[0]}")
        return diff[0]

    s16, s32 = api.cache_shapes(cfg, 1, 16), api.cache_shapes(cfg, 1, 32)
    return [{name: axis(l16[name], l32[name]) for name in l16}
            for l16, l32 in zip(s16, s32)]


def _device(cache: list) -> torch.device:
    return next(iter(cache[0].values())).device


class KVPool:
    """The physical pooled cache: ``cache`` is the model's per-layer
    cache with ``num_blocks + 1`` rows of ``block_size`` positions (the
    last row is the drop sink); ``pos_axes`` its leaves' position axes
    (``length_axes``)."""

    def __init__(self, api, cfg, *, num_blocks: int, block_size: int,
                 device) -> None:
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.pos_axes = length_axes(api, cfg)
        self.cache = api.init_cache(cfg, self.num_blocks + 1,
                                    self.block_size, device=device)

    def copy_blocks(self, dst: list[int], src: list[int]) -> None:
        """pool[src] -> pool[dst] on every leaf (copy-on-write)."""
        if not dst:
            return
        dev = _device(self.cache)
        d = torch.as_tensor(dst, device=dev)
        s = torch.as_tensor(src, device=dev)
        for layer in self.cache:
            for leaf in layer.values():
                leaf[d] = leaf[s]


def gather_blocks(cache: list, tables, pos_axes: list) -> list:
    """Pool -> dense slab view per layer: each leaf's block axis moves
    next to its position axis (``pos_axes``, per layer and leaf) and the
    (nb, bs) pair merges into one length axis of nb * bs."""
    kops.record_dispatch("gather_blocks", "dma")
    t = torch.as_tensor(tables, device=_device(cache)).long()
    out = []
    for layer, axes in zip(cache, pos_axes):
        dense = {}
        for name, leaf in layer.items():
            ax = axes[name]
            g = leaf[t].movedim(1, ax)           # (B, ..., nb, bs, ...)
            dense[name] = g.reshape(*g.shape[:ax], -1, *g.shape[ax + 2:])
        out.append(dense)
    return out


def scatter_blocks(cache: list, dense: list, tables,
                   pos_axes: list) -> None:
    """Dense slab view -> pool, in place: the inverse of
    ``gather_blocks``. Blocks shared between rows receive the values
    they already hold (decode writes only exclusive blocks) and
    duplicate scratch entries receive junk nothing reads, so the order
    of duplicate writes does not matter."""
    kops.record_dispatch("scatter_blocks", "dma")
    t = torch.as_tensor(tables, device=_device(cache)).long()
    nb = t.shape[1]
    for layer, dlayer, axes in zip(cache, dense, pos_axes):
        for name, leaf in layer.items():
            ax, g = axes[name], dlayer[name]
            g = g.reshape(*g.shape[:ax], nb, leaf.shape[ax],
                          *g.shape[ax + 1:]).movedim(ax, 1)
            leaf[t] = g.to(leaf.dtype)


def validate_tables(tables, num_blocks: int) -> None:
    """Host-side bounds check on a block-table batch before dispatch.

    The device paths carry no bounds machinery: the plain gathers index
    without a check and the CUDA kernel's table-indexed loads would
    read whatever row a corrupt entry names. This is the enforcement
    point, raising ``KVPoolError`` instead."""
    t = np.asarray(tables)
    if t.size == 0:
        return
    lo, hi = int(t.min()), int(t.max())
    if lo < 0 or hi >= num_blocks:
        raise KVPoolError(
            f"block table entry out of range: min {lo}, max {hi} for a "
            f"pool of {num_blocks} blocks — stale or corrupt table")


# ---------------------------------------------------------------------------
# Request-level orchestration: tables, prefix splicing, COW.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestBlocks:
    """One request's logical->physical mapping: ``bids[j]`` backs
    positions ``[j*bs, (j+1)*bs)``."""

    bids: list[int]
    prefix_hit_blocks: int      # LEADING bids spliced from the index
    span: int                   # positions covered: len(bids) * bs
    hit_idx: tuple[int, ...] = ()   # every spliced block index

    def table_row(self, width: int) -> np.ndarray:
        row = np.full((width,), SCRATCH_BLOCK, np.int32)
        row[: len(self.bids)] = self.bids
        return row


class PagedKVManager:
    """Allocator + device pool + prefix index, with request-granular ops:
    ``begin_request`` (prefix splice + atomic span allocation),
    ``publish_prompt`` (activate + hash-cons), ``ensure_exclusive``
    (copy-on-write), ``release_request``."""

    def __init__(self, api, cfg, *, num_blocks: int, block_size: int,
                 device) -> None:
        self.block_size = int(block_size)
        self.alloc = BlockAllocator(num_blocks)
        self.pool = KVPool(api, cfg, num_blocks=num_blocks,
                           block_size=block_size, device=device)

    @property
    def counters(self) -> PoolCounters:
        return self.alloc.counters

    def blocks_needed(self, n_positions: int) -> int:
        return -(-int(n_positions) // self.block_size)

    def _prompt_keys(self, prompt: np.ndarray,
                     n_blocks: int) -> list[tuple[bytes, bytes]]:
        cks = chunk_keys(prompt, n_blocks, self.block_size)
        return [(cks[j], prefix_key(prompt, (j + 1) * self.block_size))
                for j in range(n_blocks)]

    def check_span(self, rb: RequestBlocks, end: int) -> None:
        """A segment about to write positions up to ``end - 1`` must stay
        inside the request's span (the device path would drop them)."""
        if end > rb.span:
            raise KVPoolError(
                f"write frontier {end} exceeds the request's allocated "
                f"span {rb.span} ({len(rb.bids)} blocks of "
                f"{self.block_size}) — segment length outran allocation")

    def begin_request(self, prompt: np.ndarray, n_positions: int
                      ) -> RequestBlocks | None:
        """Splice every full prompt[:-1] block already in the index (the
        walk does not stop at the first miss), then allocate fresh
        blocks for the rest of ``n_positions`` write positions. Atomic:
        ``None`` without side effects when the pool cannot cover it."""
        bs = self.block_size
        need = self.blocks_needed(n_positions)
        n_full = (int(prompt.size) - 1) // bs
        n_walk = min(n_full, need)
        hits: list[tuple[int, int]] = []
        miss_seen = False
        leading = 0
        for j, keys in enumerate(self._prompt_keys(prompt, n_walk)):
            bid = self.alloc.lookup_any(keys)
            if bid is None:
                miss_seen = True
                continue
            hits.append((j, bid))
            if miss_seen:
                self.counters.chunk_interior_hits += 1
            else:
                leading += 1
        self.counters.prompt_blocks += n_walk
        # retain-then-check: reviving a cached hit removes it from the
        # evictable pool, so availability is measured after the retains
        for _, bid in hits:
            self.alloc.retain(bid)
        fresh_needed = need - len(hits)
        if not self.alloc.can_alloc(fresh_needed):
            for _, bid in hits:
                self.alloc.release(bid)
            return None
        fresh = [self.alloc.alloc() for _ in range(fresh_needed)]
        by_idx = dict(hits)
        it = iter(fresh)
        bids = [by_idx[j] if j in by_idx else next(it) for j in range(need)]
        return RequestBlocks(bids=bids, prefix_hit_blocks=leading,
                             span=need * bs, hit_idx=tuple(sorted(by_idx)))

    def publish_prompt(self, prompt: np.ndarray, rb: RequestBlocks) -> None:
        """At admission: staged blocks go active and every full
        prompt[:-1] block is hash-consed under both of its keys."""
        hit = set(rb.hit_idx)
        n_full = (int(prompt.size) - 1) // self.block_size
        n_walk = min(n_full, len(rb.bids))
        keys = self._prompt_keys(prompt, n_walk)
        for j, bid in enumerate(rb.bids):
            if j in hit:
                continue
            self.alloc.activate(bid)
            if j < n_walk:
                for key in keys[j]:
                    self.alloc.register(key, bid)

    def ensure_exclusive(self, rb: RequestBlocks, block_idx: int) -> bool:
        """Copy-on-write before a write into a shared or published block;
        True when a copy happened."""
        bid = rb.bids[block_idx]
        if not (self.alloc.refcount(bid) > 1
                or self.alloc.is_registered(bid)):
            return False
        new = self.alloc.alloc()
        self.pool.copy_blocks([new], [bid])
        if self.alloc.state(bid) is BlockState.ACTIVE:
            self.alloc.activate(new)
        rb.bids[block_idx] = new
        self.alloc.release(bid)
        self.counters.cow_copies += 1
        return True

    def release_request(self, rb: RequestBlocks) -> None:
        for bid in rb.bids:
            self.alloc.release(bid)
        rb.bids = []
