"""The port's SidebarBuffer and rings, alone and against the JAX model.

  * the protocol tests of ``tests/test_sidebar_protocol.py`` (placement,
    ownership, capacity, a full host invocation) and the ring tests of
    ``tests/test_sidebar_ring.py`` (seeded interleavings keep the free
    list coherent at depths 2-5, reuse before release raises at every
    depth) on the port;
  * the same seeded interleavings of buffer and ring operations driven
    through ``repro.core.sidebar`` and ``repro_torch.core.sidebar``:
    after every step both raised the same error (class and statement)
    or none, and their stats, placements, owners, free lists and slot
    states are equal;
  * the buffer holds host tensors only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import function_table as jft
from repro.core import sidebar as js
from repro_torch.core import function_table as tft
from repro_torch.core import sidebar as ts
from repro_torch.core.sidebar import (
    CONTROL_BYTES,
    Owner,
    PingPongPair,
    SidebarBuffer,
    SidebarCall,
    SidebarProtocolError,
    SidebarRing,
    _align,
    pipelined_capacity,
    required_capacity,
)

DEPTHS = (2, 3, 4, 5)
ACTIONS = ("acquire", "to_host", "to_accelerator", "release")
OPERAND_NBYTES = 192
RESULT_NBYTES = 160
TABLE = tft.make_default_table()


# ---------------------------------------------------------------------------
# Protocol (tests/test_sidebar_protocol.py on the port)
# ---------------------------------------------------------------------------


def test_placement_and_rw():
    sb = SidebarBuffer(4096)
    sb.allocate("a", 256)
    arr = torch.arange(64, dtype=torch.float32)
    sb.write(Owner.ACCELERATOR, "a", arr)
    assert torch.equal(sb.read(Owner.ACCELERATOR, "a"), arr)
    assert sb.stats.bytes_written_acc == sb.stats.bytes_read_acc == 256


def test_wrong_owner_raises():
    sb = SidebarBuffer(4096)
    sb.allocate("a", 256)
    with pytest.raises(SidebarProtocolError, match="owned by accelerator"):
        sb.write(Owner.HOST, "a", torch.zeros(4))


def test_ownership_transfer_counts_handshakes():
    sb = SidebarBuffer(4096)
    sb.pass_ownership(Owner.HOST)
    sb.pass_ownership(Owner.ACCELERATOR)
    assert sb.stats.handshakes == 2
    with pytest.raises(SidebarProtocolError):
        sb.pass_ownership(Owner.ACCELERATOR)


def test_capacity_overflow_and_small_buffer():
    sb = SidebarBuffer(1024)
    with pytest.raises(SidebarProtocolError, match="overflow"):
        sb.allocate("big", 2048)
    with pytest.raises(ValueError, match="control area"):
        SidebarBuffer(CONTROL_BYTES)


def test_write_exceeding_region_and_read_before_write():
    sb = SidebarBuffer(4096)
    sb.allocate("a", 64)
    with pytest.raises(SidebarProtocolError, match="exceeds region"):
        sb.write(Owner.ACCELERATOR, "a", torch.zeros(64))  # 256 B
    with pytest.raises(SidebarProtocolError, match="never written"):
        sb.read(Owner.ACCELERATOR, "a")


def test_full_invocation_cycle_with_a_fused_chain():
    sb = SidebarBuffer(required_capacity((16,), 4, copies=2))
    sb.allocate("in", 64)
    sb.allocate("out", 64)
    x = torch.linspace(-1, 1, 16)
    sb.write(Owner.ACCELERATOR, "in", x)
    sb.invoke_host(SidebarCall("relu", ("in",), ("out",), 16), TABLE)
    assert torch.equal(sb.read(Owner.ACCELERATOR, "out"), x.clamp_min(0))
    assert sb.owner is Owner.ACCELERATOR
    assert sb.stats.host_invocations == 1 and sb.stats.handshakes == 2
    # a chain applies each fused function on the host, then casts
    sb.pass_ownership(Owner.HOST)
    sb.host_call(SidebarCall("relu", ("in",), ("out",), 16,
                             chain=("squared_relu",)),
                 TABLE, dtype=torch.float32)
    assert torch.equal(sb.read(Owner.HOST, "out"), x.clamp_min(0) ** 2)
    assert SidebarCall("relu", (), (), 0, chain=("tanh",)).functions == (
        "relu", "tanh")


def test_free_all_and_free_list_recycling():
    sb = SidebarBuffer(4096)
    sb.allocate("a", 64)
    sb.free_all()
    sb.allocate("a", 64)
    assert sb.utilization() > 0
    sb.allocate("b", 300)
    sb.allocate("c", 64)
    cursor = sb._cursor
    sb.free("b")
    assert sb.allocate("d", 200).offset == sb.region("a").end + 64
    assert sb._cursor == cursor


def test_the_buffer_holds_host_tensors_only():
    sb = SidebarBuffer(4096)
    sb.allocate("a", 256)
    with pytest.raises(SidebarProtocolError, match="host tensors"):
        sb.write(Owner.ACCELERATOR, "a", torch.zeros(4, device="meta"))


def test_capacity_helpers_equal_jax():
    for shape, itemsize, copies in (((16,), 4, 2), ((8, 300), 2, 1),
                                    ((256, 6, 28, 28), 4, 2)):
        assert (required_capacity(shape, itemsize, copies)
                == js.required_capacity(shape, itemsize, copies))
    for tiles in (1, 2, 3, 4, 8):
        for depth in (None, 2):
            args = ((12, 40), (12, 40), 4)
            assert (pipelined_capacity(*args, tiles=tiles, depth=depth)
                    == js.pipelined_capacity(*args, tiles=tiles,
                                             depth=depth))
    assert pipelined_capacity((), (), 4) == js.pipelined_capacity((), (), 4)


# ---------------------------------------------------------------------------
# Rings (tests/test_sidebar_ring.py on the port)
# ---------------------------------------------------------------------------


def _capacity(depth: int) -> int:
    return CONTROL_BYTES + depth * (
        _align(OPERAND_NBYTES) + _align(RESULT_NBYTES)) + 1024


def _free_list_invariants(sb: SidebarBuffer) -> None:
    spans = list(sb._free)
    assert spans == sorted(spans)
    end_prev = CONTROL_BYTES
    for off, size in spans:
        assert off % 128 == 0 and size % 128 == 0 and size > 0
        assert off >= end_prev
        end_prev = off + size
    assert end_prev <= sb._cursor <= sb.capacity
    for region in sb.regions():
        for off, size in spans:
            assert region.end <= off or region.offset >= off + size


def _drain(ring: SidebarRing) -> None:
    order = {"filled": ("to_host", "to_accelerator", "release"),
             "at_host": ("to_accelerator", "release"),
             "returned": ("release",), "free": ()}
    for slot in ring.slots:
        for action in order[slot.state]:
            getattr(ring, action)(slot)


def _walk(depth: int, choices: list[int]) -> None:
    sb = SidebarBuffer(_capacity(depth))
    ring = SidebarRing(sb, "ring", OPERAND_NBYTES, RESULT_NBYTES,
                       depth=depth)
    next_tile = 0
    payload = torch.zeros(OPERAND_NBYTES // 4)
    for c in choices:
        action = ACTIONS[c % len(ACTIONS)]
        slot = ring.slots[(c // len(ACTIONS)) % depth]
        before = [(s.label, s.state) for s in ring.slots]
        owners = {s.label: (sb.region_owner(s.operand.name),
                            sb.region_owner(s.result.name))
                  for s in ring.slots}
        try:
            if action == "acquire":
                legal = ring.slot(next_tile).state == "free"
                got = ring.acquire(next_tile)
                sb.write(Owner.ACCELERATOR, got.operand.name, payload)
                next_tile += 1
            elif action == "to_host":
                legal = slot.state == "filled"
                ring.to_host(slot)
            elif action == "to_accelerator":
                legal = slot.state == "at_host"
                ring.to_accelerator(slot)
            else:
                legal = slot.state == "returned"
                ring.release(slot)
            assert legal, f"{action} should have raised"
        except SidebarProtocolError:
            assert not legal, f"legal {action} raised"
            assert [(s.label, s.state) for s in ring.slots] == before
            assert owners == {s.label: (sb.region_owner(s.operand.name),
                                        sb.region_owner(s.result.name))
                              for s in ring.slots}
        _free_list_invariants(sb)
    _drain(ring)
    ring.free()
    _free_list_invariants(sb)
    cursor = sb._cursor
    again = SidebarRing(sb, "again", OPERAND_NBYTES, RESULT_NBYTES,
                        depth=depth)
    _drain(again)
    again.free()
    assert sb._cursor <= cursor
    _free_list_invariants(sb)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("seed", range(6))
def test_random_interleavings_keep_free_list_coherent(depth, seed):
    rng = np.random.default_rng(1000 * depth + seed)
    _walk(depth, [int(v) for v in rng.integers(0, 4 * depth, size=200)])


@pytest.mark.parametrize("depth", DEPTHS)
def test_reuse_before_release_raises_at_every_depth(depth):
    sb = SidebarBuffer(_capacity(depth))
    ring = SidebarRing(sb, "ring", OPERAND_NBYTES, RESULT_NBYTES,
                       depth=depth)
    for t in range(depth):
        ring.to_host(ring.acquire(t))
    with pytest.raises(SidebarProtocolError, match="reused before release"):
        ring.acquire(depth)
    victim = ring.slot(0)
    ring.to_accelerator(victim)
    with pytest.raises(SidebarProtocolError, match="reused before release"):
        ring.acquire(depth)
    ring.release(victim)
    assert ring.acquire(depth) is victim
    with pytest.raises(SidebarProtocolError, match="mid-flight"):
        ring.free()


def test_ring_depth_validation_and_ping_pong():
    sb = SidebarBuffer(_capacity(2))
    with pytest.raises(ValueError, match="depth"):
        SidebarRing(sb, "bad", 64, 64, depth=0)
    pair = PingPongPair(sb, "pp", 64, 64)
    assert pair.depth == 2 and pair.slot(3) is pair.slots[1]


# ---------------------------------------------------------------------------
# The same interleavings through both buffers
# ---------------------------------------------------------------------------

_NAMES = ("a", "b", "c", "d")
_SIZES = (64, 160, 300, 520)


class _Side:
    """One buffer (JAX's or the port's) with a ring, driven by actions."""

    def __init__(self, mod, owner, table, tensor, depth):
        self.mod, self.O, self.table, self.tensor = mod, owner, table, tensor
        self.sb = mod.SidebarBuffer(4096, name="x")
        self.ring = mod.SidebarRing(self.sb, "ring", OPERAND_NBYTES,
                                    RESULT_NBYTES, depth=depth)
        self.next_tile = 0

    def do(self, kind, k, size, who):
        O, sb, ring = self.O, self.sb, self.ring
        slot = ring.slots[k % ring.depth]
        who = (O.ACCELERATOR, O.HOST)[who]
        name = _NAMES[k % len(_NAMES)]
        if kind == "acquire":
            got = ring.acquire(self.next_tile)
            sb.write(O.ACCELERATOR, got.operand.name,
                     self.tensor(np.full(OPERAND_NBYTES // 4, 1.5,
                                         np.float32)))
            self.next_tile += 1
        elif kind in ("to_host", "to_accelerator", "release"):
            getattr(ring, kind)(slot)
        elif kind == "allocate":
            sb.allocate(name, size)
        elif kind == "free":
            sb.free(name)
        elif kind == "write":
            sb.write(who, name, self.tensor(
                np.linspace(-1, 1, size // 4, dtype=np.float32)))
        elif kind == "read":
            return np.asarray(sb.read(who, name))
        elif kind == "pass_region":
            sb.pass_region(name, who)
        elif kind == "pass_ownership":
            sb.pass_ownership(who)
        elif kind == "invoke":
            sb.invoke_host(self.mod.SidebarCall(
                "relu", (name,), (_NAMES[(k + 1) % len(_NAMES)],), 0),
                self.table)
        return None

    def state(self):
        sb = self.sb
        return (dataclasses.asdict(sb.stats),
                sorted((r.name, r.offset, r.nbytes) for r in sb.regions()),
                sorted((n, o.value) for n, o in sb._owners.items()),
                sb.owner.value, list(sb._free), sb._cursor,
                [s.state for s in self.ring.slots])


def _head(message: str) -> str:
    """An error's statement, without the advice after it (the JAX
    overflow message points at a TPU BlockSpec)."""
    return message.split(" — ")[0].split("; ")[0]


_KINDS = ("acquire", "to_host", "to_accelerator", "release", "allocate",
          "free", "write", "read", "pass_region", "pass_ownership", "invoke")


@pytest.mark.parametrize("depth", (1, 2, 3, 4))
@pytest.mark.parametrize("seed", range(3))
def test_interleavings_match_the_jax_buffer(depth, seed):
    rng = np.random.default_rng(77 + 10 * depth + seed)
    sides = (_Side(js, js.Owner, jft.make_default_table(), lambda a: a,
                   depth),
             _Side(ts, ts.Owner, tft.make_default_table(),
                   lambda a: torch.from_numpy(a.copy()), depth))
    raised = 0
    for _ in range(300):
        step = (_KINDS[int(rng.integers(len(_KINDS)))],
                int(rng.integers(8)), int(_SIZES[rng.integers(4)]),
                int(rng.integers(2)))
        outcomes = []
        for side in sides:
            try:
                outcomes.append(("ok", side.do(*step)))
            except (js.SidebarProtocolError, ts.SidebarProtocolError) as e:
                outcomes.append((type(e).__name__, _head(str(e))))
        (jo, jv), (to, tv) = outcomes
        assert jo == to, (step, outcomes)
        if jo == "ok" and jv is not None:
            np.testing.assert_array_equal(tv, jv)
        elif jo != "ok":
            assert jv == tv, step
            raised += 1
        assert sides[0].state() == sides[1].state(), step
    assert raised > 0
