"""The Sidebar buffer and its access protocol (paper §3), and the spill
region of the paged server (mirror of ``repro.core.sidebar``).

The paper's Sidebar is a small SRAM shared by the accelerator and the
host, with compile-time-agreed placement (§3.1), mutual exclusion by
ownership passed through a flag register, and dedicated slots for the
call arguments and the invoke / return flags (§3.3). This module models
that protocol, so it is testable and the engine can count its handshakes
and bytes exactly:

  * ``SidebarBuffer`` tracks ownership per region, the placement map (a
    first-fit free list over a bump allocator) and the traffic
    (``SidebarStats``); an access by the wrong owner raises
    ``SidebarProtocolError``, the software analogue of the hardware
    mutex;
  * ``SidebarCall`` is the argument block the accelerator writes before
    raising the invoke flag: a function-table key, region names and the
    fused ``chain`` of a run of consecutive flexible ops;
  * ``SidebarRing`` is the T-deep discipline of SIDEBAR_PIPELINED:
    ``depth`` (operand, result) slots, each cycling free -> filled ->
    at_host -> returned -> free; acquiring a slot mid-cycle raises
    ("reuse before release"). ``PingPongPair`` is depth 2.

This is the host side, so a region holds CPU tensors only: the engine
copies an operand off the card before it writes it here
(``core/engine.py``), and ``write`` refuses a tensor on any other
device. Placements align to 128 bytes (the card's cache line), so the
byte and peak counts equal the JAX model's.

The spill region below parks a preempted serving request's KV blocks
(CPU tensors) with its own ownership lifecycle:

    stage(handle) -> commit(handle, payload) -> fetch -> release

Any out-of-order transition, or a commit past ``capacity_bytes``,
raises ``SidebarProtocolError``, the one error class of both.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterator, Sequence

import torch


class Owner(enum.Enum):
    ACCELERATOR = "accelerator"
    HOST = "host"


class SidebarProtocolError(RuntimeError):
    """Raised on any violation of the ownership / placement protocol."""


@dataclasses.dataclass(frozen=True)
class Region:
    """A compile-time-agreed placement inside the sidebar."""

    name: str
    offset: int
    nbytes: int

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


@dataclasses.dataclass(frozen=True)
class SidebarCall:
    """The argument block of one host invocation (paper §3.3). ``chain``
    is the fused tail of a run of consecutive flexible ops: the host
    applies ``function``, then each chained function, and writes back
    only the final result (one ownership round trip for the run)."""

    function: str          # function-table key ("function pointer")
    in_regions: tuple[str, ...]
    out_regions: tuple[str, ...]
    n_elements: int        # payload size (drives the host cost)
    chain: tuple[str, ...] = ()  # fused follow-on function-table keys

    @property
    def functions(self) -> tuple[str, ...]:
        return (self.function, *self.chain)


@dataclasses.dataclass
class SidebarStats:
    """Traffic/protocol counters consumed by the energy model."""

    bytes_written_acc: int = 0   # accelerator -> sidebar
    bytes_read_acc: int = 0      # sidebar -> accelerator
    bytes_written_host: int = 0  # host -> sidebar
    bytes_read_host: int = 0     # sidebar -> host
    handshakes: int = 0          # ownership transfers (flag writes)
    host_invocations: int = 0    # complete invoke->return cycles
    peak_bytes: int = 0          # high-water allocation mark
    # overlap counters (abstract cycles; 1 cycle = one tensor-core
    # flop-time)
    host_busy_cycles: int = 0    # host busy on flexible functions
    acc_busy_cycles: int = 0     # accelerator busy on static ops
    overlap_cycles: int = 0      # both sides busy simultaneously
    stall_cycles: int = 0        # accelerator idle, polling a flag

    @property
    def total_bytes(self) -> int:
        return (self.bytes_written_acc + self.bytes_read_acc
                + self.bytes_written_host + self.bytes_read_host)

    def merge(self, other: "SidebarStats") -> "SidebarStats":
        return SidebarStats(
            bytes_written_acc=self.bytes_written_acc + other.bytes_written_acc,
            bytes_read_acc=self.bytes_read_acc + other.bytes_read_acc,
            bytes_written_host=(self.bytes_written_host
                                + other.bytes_written_host),
            bytes_read_host=self.bytes_read_host + other.bytes_read_host,
            handshakes=self.handshakes + other.handshakes,
            host_invocations=self.host_invocations + other.host_invocations,
            peak_bytes=max(self.peak_bytes, other.peak_bytes),
            host_busy_cycles=self.host_busy_cycles + other.host_busy_cycles,
            acc_busy_cycles=self.acc_busy_cycles + other.acc_busy_cycles,
            overlap_cycles=self.overlap_cycles + other.overlap_cycles,
            stall_cycles=self.stall_cycles + other.stall_cycles,
        )


# Reserved control area at the head of every sidebar: invoke flag, return
# flag, function pointer slot and an argument block (paper §3.3).
CONTROL_BYTES = 256

_ALIGN = 128  # every placement starts on a 128-byte line


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class SidebarBuffer:
    """Ownership-checked, capacity-checked sidebar with a recycling
    (free-list + bump) allocator and per-region ownership.

    ``owner`` is the buffer-level default: new regions belong to it, and
    ``pass_ownership`` (the serial protocol's one flag) moves the buffer
    and every region. ``pass_region`` is the pipelined refinement: one
    flag write moves a named set of regions (a ring slot) while the rest
    stays with its owner."""

    def __init__(self, capacity: int, *, name: str = "sidebar") -> None:
        if capacity <= CONTROL_BYTES:
            raise ValueError("sidebar too small for its control area")
        self.name = name
        self.capacity = int(capacity)
        self.owner = Owner.ACCELERATOR
        self.stats = SidebarStats()
        self._regions: dict[str, Region] = {}
        self._owners: dict[str, Owner] = {}
        self._cursor = CONTROL_BYTES
        self._free: list[tuple[int, int]] = []  # (offset, span), aligned
        self._data: dict[str, torch.Tensor] = {}

    # -- placement (compile-time agreement, §3.1) -------------------------
    def allocate(self, name: str, nbytes: int) -> Region:
        if name in self._regions:
            raise SidebarProtocolError(f"region {name!r} already placed")
        nbytes = int(nbytes)
        span = _align(max(nbytes, 1))
        # first fit from the free list (recycled placements)
        for idx, (off, sz) in enumerate(self._free):
            if sz >= span:
                if sz == span:
                    self._free.pop(idx)
                else:
                    self._free[idx] = (off + span, sz - span)
                region = Region(name, off, nbytes)
                self._regions[name] = region
                self._owners[name] = self.owner
                return region
        aligned = _align(self._cursor)
        if aligned + nbytes > self.capacity:
            raise SidebarProtocolError(
                f"sidebar {self.name!r} overflow: need {nbytes} B at offset "
                f"{aligned}, capacity {self.capacity} B; intermediates must "
                "be tiled to fit")
        region = Region(name, aligned, nbytes)
        self._regions[name] = region
        self._owners[name] = self.owner
        self._cursor = aligned + span
        self.stats.peak_bytes = max(self.stats.peak_bytes, region.end)
        return region

    def free(self, name: str) -> None:
        """Return one placement to the free list (coalesced; a free tail
        goes back to the bump cursor)."""
        region = self.region(name)
        del self._regions[name]
        self._owners.pop(name, None)
        self._data.pop(name, None)
        self._free.append((region.offset, _align(max(region.nbytes, 1))))
        self._free.sort()
        merged: list[tuple[int, int]] = []
        for off, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        if merged and merged[-1][0] + merged[-1][1] >= self._cursor:
            self._cursor = merged.pop()[0]
        self._free = merged

    def free_all(self) -> None:
        """Reset placements between accelerator tasks (intermediates only:
        the sidebar never persists application state, §3.4)."""
        self._regions.clear()
        self._owners.clear()
        self._data.clear()
        self._free.clear()
        self._cursor = CONTROL_BYTES

    def region(self, name: str) -> Region:
        try:
            return self._regions[name]
        except KeyError:
            raise SidebarProtocolError(f"no region {name!r} placed") from None

    # -- ownership (hardware mutex, §3.1) ---------------------------------
    def region_owner(self, name: str) -> Owner:
        self.region(name)  # existence check
        return self._owners[name]

    def _check_owner(self, who: Owner, region_name: str) -> None:
        owner = self.region_owner(region_name)
        if owner is not who:
            raise SidebarProtocolError(
                f"{who.value} accessed region {region_name!r} owned by "
                f"{owner.value}; ownership must be passed via the flag "
                "register first")

    def pass_ownership(self, to: Owner) -> None:
        """Serial protocol: one flag transfers the whole sidebar."""
        if to is self.owner:
            raise SidebarProtocolError(f"ownership already with {to.value}")
        self.owner = to
        for name in self._owners:
            self._owners[name] = to
        self.stats.handshakes += 1

    def pass_region(self, names: Sequence[str] | str, to: Owner) -> None:
        """Pipelined protocol: one flag write transfers a set of regions
        while the rest of the sidebar stays put."""
        if isinstance(names, str):
            names = (names,)
        for name in names:
            if self.region_owner(name) is to:
                raise SidebarProtocolError(
                    f"region {name!r} ownership already with {to.value}")
        for name in names:
            self._owners[name] = to
        self.stats.handshakes += 1

    # -- data movement ----------------------------------------------------
    def write(self, who: Owner, region_name: str, array: torch.Tensor
              ) -> None:
        self._check_owner(who, region_name)
        region = self.region(region_name)
        if array.device.type != "cpu":
            raise SidebarProtocolError(
                f"write of a {array.device.type} tensor to region "
                f"{region_name!r}: the sidebar holds host tensors")
        nbytes = _nbytes(array)
        if nbytes > region.nbytes:
            raise SidebarProtocolError(
                f"write of {nbytes} B exceeds region {region_name!r} "
                f"({region.nbytes} B)")
        self._data[region_name] = array
        if who is Owner.ACCELERATOR:
            self.stats.bytes_written_acc += nbytes
        else:
            self.stats.bytes_written_host += nbytes

    def read(self, who: Owner, region_name: str) -> torch.Tensor:
        self._check_owner(who, region_name)
        self.region(region_name)
        if region_name not in self._data:
            raise SidebarProtocolError(f"region {region_name!r} never written")
        arr = self._data[region_name]
        if who is Owner.ACCELERATOR:
            self.stats.bytes_read_acc += _nbytes(arr)
        else:
            self.stats.bytes_read_host += _nbytes(arr)
        return arr

    # -- host-side computation (paper §3.3) --------------------------------
    def host_call(self, call: SidebarCall, table,
                  dtype: torch.dtype = torch.float32) -> None:
        """Host side of one invocation: read the host-owned operand
        regions, apply the table's callable and then each ``chain``
        entry, cast to ``dtype``, write the host-owned result regions.
        The regions must already be with the host."""
        entry = table[call.function]
        inputs = [self.read(Owner.HOST, r) for r in call.in_regions]
        out = entry.fn(*inputs)
        for fused in call.chain:  # fused run: stays on the host
            out = table[fused].fn(out)
        out = out.to(dtype)
        outs = [out] if len(call.out_regions) == 1 else list(out)
        for region_name, arr in zip(call.out_regions, outs):
            self.write(Owner.HOST, region_name, arr)
        self.stats.host_invocations += 1

    def invoke_host(self, call: SidebarCall, table,
                    dtype: torch.dtype = torch.float32) -> None:
        """One serial accelerator -> host -> accelerator cycle: the
        accelerator owns the buffer and has written ``in_regions``; the
        flag passes to the host, which computes and writes the results,
        and back. The accelerator stalls for the whole cycle."""
        if self.owner is not Owner.ACCELERATOR:
            raise SidebarProtocolError(
                f"accelerator accessed sidebar owned by {self.owner.value}; "
                "ownership must be passed via the flag register first")
        self.pass_ownership(Owner.HOST)
        self.host_call(call, table, dtype)
        self.pass_ownership(Owner.ACCELERATOR)

    # -- introspection ------------------------------------------------------
    def utilization(self) -> float:
        return self._cursor / self.capacity

    def regions(self) -> Iterator[Region]:
        return iter(self._regions.values())


# ---------------------------------------------------------------------------
# T-deep ring buffering (the pipelined protocol's region discipline).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RingSlot:
    """One slot of a sidebar ring: an (operand, result) region pair and
    its lifecycle state."""

    label: str
    operand: Region
    result: Region
    state: str = "free"  # free -> filled -> at_host -> returned -> free

    @property
    def region_names(self) -> tuple[str, str]:
        return (self.operand.name, self.result.name)


class SidebarRing:
    """``depth`` sidebar slots traded between accelerator and host. Tile
    ``t`` maps onto slot ``t % depth``; a slot completes free -> filled
    -> at_host -> returned -> free before it can be acquired again."""

    def __init__(self, sb: SidebarBuffer, name: str,
                 operand_nbytes: int, result_nbytes: int,
                 depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self._sb = sb
        self.name = name
        self.depth = depth
        self.slots = [
            RingSlot(f"slot{k}",
                     sb.allocate(f"{name}.slot{k}.operand", operand_nbytes),
                     sb.allocate(f"{name}.slot{k}.result", result_nbytes))
            for k in range(depth)
        ]

    def slot(self, tile_index: int) -> RingSlot:
        return self.slots[tile_index % self.depth]

    def acquire(self, tile_index: int) -> RingSlot:
        s = self.slot(tile_index)
        if s.state != "free":
            raise SidebarProtocolError(
                f"ring slot {self.name}.{s.label} reused before release "
                f"(state={s.state!r}); the tile {self.depth} back must have "
                "its result read back and the slot released first")
        s.state = "filled"
        return s

    def to_host(self, s: RingSlot) -> None:
        if s.state != "filled":
            raise SidebarProtocolError(
                f"slot {self.name}.{s.label} invoked in state {s.state!r} "
                "(operand not filled)")
        self._sb.pass_region(s.region_names, Owner.HOST)
        s.state = "at_host"

    def to_accelerator(self, s: RingSlot) -> None:
        if s.state != "at_host":
            raise SidebarProtocolError(
                f"slot {self.name}.{s.label} returned in state {s.state!r}")
        self._sb.pass_region(s.region_names, Owner.ACCELERATOR)
        s.state = "returned"

    def release(self, s: RingSlot) -> None:
        if s.state != "returned":
            raise SidebarProtocolError(
                f"slot {self.name}.{s.label} released in state {s.state!r} "
                "(result not returned to the accelerator)")
        s.state = "free"

    def free(self) -> None:
        """Return every slot's placements to the buffer's free list."""
        for s in self.slots:
            if s.state != "free":
                raise SidebarProtocolError(
                    f"slot {self.name}.{s.label} freed mid-flight "
                    f"(state={s.state!r})")
            self._sb.free(s.operand.name)
            self._sb.free(s.result.name)


class PingPongPair(SidebarRing):
    """The depth-2 ring, the named special case."""

    def __init__(self, sb: SidebarBuffer, name: str,
                 operand_nbytes: int, result_nbytes: int) -> None:
        super().__init__(sb, name, operand_nbytes, result_nbytes, depth=2)


def required_capacity(shape: tuple[int, ...], itemsize: int,
                      copies: int = 1) -> int:
    """Capacity to stage an intermediate of ``shape``: the control area
    plus ``copies`` aligned regions."""
    nbytes = int(math.prod(shape)) * itemsize
    return CONTROL_BYTES + copies * _align(nbytes)


def pipelined_capacity(
    operand_shape: tuple[int, ...],
    out_shape: tuple[int, ...],
    itemsize: int,
    tiles: int = 2,
    depth: int | None = None,
) -> int:
    """Capacity for one ring-buffered flexible op: ``depth`` slots
    (default ``tiles``), each an (operand-tile, result-tile) pair, tiles
    split along the leading axis (the larger, ceil-sized tile)."""
    depth = tiles if depth is None else depth

    def tile_bytes(shape: tuple[int, ...]) -> int:
        if not shape:
            return itemsize
        lead = -(-shape[0] // tiles)
        return int(lead * math.prod(shape[1:])) * itemsize

    return CONTROL_BYTES + depth * (
        _align(tile_bytes(operand_shape)) + _align(tile_bytes(out_shape)))


class _SpillState(enum.Enum):
    STAGED = "staged"    # handle reserved, payload being written
    ACTIVE = "active"    # payload committed, restorable


class SidebarSpillRegion:
    """Host-side spill scratchpad for preempted serving requests (see the
    module docstring).
    ``capacity_bytes`` bounds the region (None: unbounded);
    ``in_use_bytes`` / ``peak_bytes`` account committed payloads,
    ``spills`` counts commits and ``restores`` fetches."""

    def __init__(self, capacity_bytes: int | None = None) -> None:
        self.capacity_bytes = capacity_bytes
        self._entries: dict[int, tuple[_SpillState, object, int]] = {}
        self.in_use_bytes = 0
        self.peak_bytes = 0
        self.spills = 0      # commits
        self.restores = 0    # fetches

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, handle: int) -> bool:
        return handle in self._entries

    def stage(self, handle: int) -> None:
        """Reserve a handle (free -> staged)."""
        if handle in self._entries:
            st, _, _ = self._entries[handle]
            raise SidebarProtocolError(
                f"spill handle {handle} already {st.value} "
                "(stage before the previous owner released)")
        self._entries[handle] = (_SpillState.STAGED, None, 0)

    def commit(self, handle: int, payload, nbytes: int) -> None:
        """staged -> active: the spill copy is complete and restorable."""
        entry = self._entries.get(handle)
        if entry is None or entry[0] is not _SpillState.STAGED:
            raise SidebarProtocolError(
                f"commit on spill handle {handle} "
                f"({'unstaged' if entry is None else entry[0].value})")
        nbytes = int(nbytes)
        if (self.capacity_bytes is not None
                and self.in_use_bytes + nbytes > self.capacity_bytes):
            raise SidebarProtocolError(
                f"spill region over capacity: {self.in_use_bytes} + "
                f"{nbytes} > {self.capacity_bytes} bytes")
        self._entries[handle] = (_SpillState.ACTIVE, payload, nbytes)
        self.in_use_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.in_use_bytes)
        self.spills += 1

    def fetch(self, handle: int):
        """Read an active entry's payload (non-consuming: the caller
        releases only once the restore has succeeded)."""
        entry = self._entries.get(handle)
        if entry is None or entry[0] is not _SpillState.ACTIVE:
            raise SidebarProtocolError(
                f"fetch on spill handle {handle} "
                f"({'unknown' if entry is None else entry[0].value})")
        self.restores += 1
        return entry[1]

    def release(self, handle: int) -> None:
        """Drop an entry (staged or active) and reclaim its bytes."""
        entry = self._entries.pop(handle, None)
        if entry is None:
            raise SidebarProtocolError(
                f"release on unknown spill handle {handle}")
        self.in_use_bytes -= entry[2]
