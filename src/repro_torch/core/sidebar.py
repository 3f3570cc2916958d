"""The Sidebar spill region: host-side scratchpad for preempted serving
requests (mirror of ``repro.core.sidebar``'s ``SidebarProtocolError``
and ``SidebarSpillRegion``).

The paged server's preemption path parks a victim's KV blocks here
while it waits to resume — the Sidebar discipline pointed the other
way: instead of the host reading accelerator intermediates out of a
shared scratchpad, the scheduler parks accelerator state (block
payloads, as CPU tensors) in a host region with an explicit ownership
lifecycle:

    stage(handle) -> commit(handle, payload) -> fetch -> release

Any out-of-order transition — commit without stage, fetch of an
uncommitted handle, staging a live handle twice, release of an unknown
one — raises ``SidebarProtocolError``; so does a commit past
``capacity_bytes``.

The rest of the JAX module (``SidebarBuffer``, its rings and the
analytical engine's accounting) is ported with the engine, ROADMAP
Queue 1 item 7.
"""

from __future__ import annotations

import enum


class SidebarProtocolError(RuntimeError):
    """Raised on any violation of the ownership / placement protocol."""


class _SpillState(enum.Enum):
    STAGED = "staged"    # handle reserved, payload being written
    ACTIVE = "active"    # payload committed, restorable


class SidebarSpillRegion:
    """Host-side spill scratchpad (see the module docstring).
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


__all__ = ["SidebarProtocolError", "SidebarSpillRegion"]
