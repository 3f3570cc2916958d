"""Prefix-affinity replica router: data parallelism over paged servers
(mirror of ``repro.launch.router``).

N independent ``PagedContinuousBatchingServer`` replicas, each with its
own KV block pool and prefix index, behind one front end. The router
probes every replica's index (``PagedKVManager.chunk_affinity``, a
side-effect-free ``peek`` walk) and steers a request to the replica
holding the most warm prompt blocks, least outstanding load breaking
ties and the no-hit case; ``policy="random"`` sprays with a seeded
``np.random.RandomState`` (the JAX router's draws, in its order).

  * **Work stealing** — a replica that spilled a request is overloaded;
    when a sibling has a free slot and strictly less load, the router
    moves the spilled payload there (host CPU tensors, handed over as
    they are), preferring a sibling whose index still holds the prompt.
    Priority, deadline and first-token time travel with it.
  * **Replica health** — ``quarantine_after`` consecutive dispatch
    errors (the fault injector's ``dispatch:i`` site) quarantine a
    replica for ``backoff_steps`` router steps, doubling on every failed
    reprobe and reset on the first clean step. Its queued work is
    untouched.

Request ids are fleet-global: ``submit`` returns a fleet rid and the
router retags each replica's ``FinishedRequest``. ``FleetStats`` sums
the replicas' ``SchedulerStats`` and adds the routing counters.

The replicas may share one ``params`` dict (servers on one device), so
two replicas of a model cost one set of weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.scheduler import (
    FinishedRequest,
    PagedContinuousBatchingServer,
    SchedulerStats,
)


@dataclasses.dataclass
class FleetStats:
    """Routing counters + the element-wise sum of replica stats."""

    requests: int = 0
    affinity_routed: int = 0     # steered by a prefix-index hit
    fallback_routed: int = 0     # no hit anywhere -> least-loaded
    random_routed: int = 0       # policy="random" assignments
    stolen: int = 0              # spilled requests migrated to a sibling
    dispatch_errors: int = 0     # injected replica dispatch faults
    quarantine_events: int = 0   # times a replica entered quarantine
    totals: SchedulerStats = dataclasses.field(
        default_factory=SchedulerStats)

    @property
    def prefix_hit_rate(self) -> float:
        return self.totals.prefix_hit_rate

    def summary(self) -> str:
        lines = [
            f"fleet: {self.requests} requests — "
            f"{self.affinity_routed} affinity-routed, "
            f"{self.fallback_routed} least-loaded, "
            f"{self.random_routed} random",
        ]
        if self.stolen or self.dispatch_errors or self.quarantine_events:
            lines.append(
                f"fleet health: {self.stolen} stolen, "
                f"{self.dispatch_errors} dispatch errors, "
                f"{self.quarantine_events} quarantines")
        lines.append(self.totals.summary())
        return "\n".join(lines)


def sum_stats(per_replica: list[SchedulerStats]) -> SchedulerStats:
    """Element-wise sum of the counters; the per-class latency samples
    concatenate (fleet tails come from the pooled samples)."""
    out = SchedulerStats()
    for st in per_replica:
        for f in dataclasses.fields(SchedulerStats):
            mine, theirs = getattr(out, f.name), getattr(st, f.name)
            if isinstance(mine, dict):
                for k, v in theirs.items():
                    mine.setdefault(k, []).extend(v)
            else:
                setattr(out, f.name, mine + theirs)
    return out


@dataclasses.dataclass
class _ReplicaHealth:
    """Dispatch-fault bookkeeping for one replica."""

    consecutive_errors: int = 0
    quarantined_until: int = 0   # router step index; < means serving
    backoff: int = 0             # current quarantine length (steps)


class ReplicaRouter:
    """Front end over N paged replicas (see the module docstring).

    >>> fleet = ReplicaRouter([srv_a, srv_b])
    >>> fleet.submit(prompt, max_new_tokens=16)
    >>> done = fleet.run()        # drain every replica
    """

    POLICIES = ("prefix", "random")

    def __init__(self, replicas: list[PagedContinuousBatchingServer], *,
                 policy: str = "prefix", seed: int = 0,
                 faults: FaultInjector | None = None,
                 quarantine_after: int = 3, backoff_steps: int = 4,
                 steal: bool = True) -> None:
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if policy not in self.POLICIES:
            raise ValueError(
                f"policy must be one of {self.POLICIES}, got {policy!r}")
        if quarantine_after < 1 or backoff_steps < 1:
            raise ValueError("quarantine_after and backoff_steps "
                             "must be >= 1")
        self.replicas = list(replicas)
        self.policy = policy
        self.faults = faults
        self.quarantine_after = quarantine_after
        self.backoff_steps = backoff_steps
        self.steal = steal
        self._rng = np.random.RandomState(seed)
        self._next_fid = 0
        self._step_i = 0
        # fleet rid -> (replica index, replica-local rid)
        self._placement: dict[int, tuple[int, int]] = {}
        self._by_replica: list[dict[int, int]] = [
            {} for _ in self.replicas]
        self._health = [_ReplicaHealth() for _ in self.replicas]
        self.stats = FleetStats()

    # -- routing -----------------------------------------------------------
    def _serving(self, idx: int) -> bool:
        return self._step_i >= self._health[idx].quarantined_until

    @property
    def quarantined(self) -> list[int]:
        """Indices of replicas under quarantine now."""
        return [i for i in range(len(self.replicas))
                if not self._serving(i)]

    def _choose(self, prompt: np.ndarray) -> int:
        if self.policy == "random":
            self.stats.random_routed += 1
            return int(self._rng.randint(len(self.replicas)))
        affinity = [r.mgr.chunk_affinity(prompt) for r in self.replicas]
        best = max(affinity)
        if best > 0:
            tied = [i for i, a in enumerate(affinity) if a == best]
            self.stats.affinity_routed += 1
            return min(tied, key=lambda i: self.replicas[i].load)
        self.stats.fallback_routed += 1
        return min(range(len(self.replicas)),
                   key=lambda i: self.replicas[i].load)

    def submit(self, prompt, max_new_tokens: int, sample=None, *,
               priority: int = 0, ttft_target: float | None = None,
               itl_target: float | None = None) -> int:
        prompt_arr = np.asarray(prompt, np.int32).reshape(-1)
        idx = self._choose(prompt_arr)
        local = self.replicas[idx].submit(
            prompt_arr, max_new_tokens, sample, priority=priority,
            ttft_target=ttft_target, itl_target=itl_target)
        fid = self._next_fid
        self._next_fid += 1
        self._placement[fid] = (idx, local)
        self._by_replica[idx][local] = fid
        self.stats.requests += 1
        return fid

    def cancel(self, fid: int) -> bool:
        """Client abort by fleet rid, wherever the request lives now."""
        placed = self._placement.get(fid)
        if placed is None:
            return False
        idx, local = placed
        if not self.replicas[idx].cancel(local):
            return False
        del self._placement[fid]
        self._by_replica[idx].pop(local, None)
        return True

    # -- health ------------------------------------------------------------
    def _on_dispatch_error(self, idx: int) -> None:
        h = self._health[idx]
        h.consecutive_errors += 1
        self.stats.dispatch_errors += 1
        if h.consecutive_errors >= self.quarantine_after:
            # each consecutive trip doubles the backoff
            h.backoff = (h.backoff * 2 if h.backoff
                         else self.backoff_steps)
            h.quarantined_until = self._step_i + h.backoff
            self.stats.quarantine_events += 1

    # -- work stealing -----------------------------------------------------
    def _steal(self) -> None:
        """Migrate spilled requests to a strictly less loaded sibling
        with a free slot, preferring one whose index holds the prompt
        warm, then the least loaded."""
        if not self.steal:
            return
        for idx, rep in enumerate(self.replicas):
            if not rep._spilled:
                continue
            for sp in list(rep._spilled):
                need_len = int(sp.req.prompt.size) + sp.req.max_new - 1
                cands = [
                    j for j, o in enumerate(self.replicas)
                    if j != idx and self._serving(j)
                    and any(s.free for s in o.slots)
                    and o.load < rep.load
                    and need_len < o.max_len
                    and o.mgr.blocks_needed(need_len)
                    <= o.mgr.alloc.capacity
                ]
                if not cands:
                    continue
                aff = {j: self.replicas[j].mgr.chunk_affinity(
                    sp.req.prompt) for j in cands}
                best = max(aff.values())
                pool = [j for j in cands if aff[j] == best]
                j = min(pool, key=lambda j: self.replicas[j].load)
                taken = rep.take_spilled(sp.req.rid)
                if taken is None:
                    continue
                fid = self._by_replica[idx].pop(sp.req.rid)
                sp2, payload = taken
                local = self.replicas[j].submit_spilled(sp2, payload)
                self._placement[fid] = (j, local)
                self._by_replica[j][local] = fid
                self.stats.stolen += 1

    # -- draining ----------------------------------------------------------
    def _retag(self, idx: int,
               finished: list[FinishedRequest]) -> list[FinishedRequest]:
        out = []
        for r in finished:
            fid = self._by_replica[idx].pop(r.rid)
            del self._placement[fid]
            out.append(dataclasses.replace(r, rid=fid))
        return out

    def step(self, *, draining: bool = False) -> list[FinishedRequest]:
        """One iteration on every serving replica that has work
        (quarantined ones skipped until their backoff expires), then
        work stealing."""
        done: list[FinishedRequest] = []
        self._step_i += 1
        for idx, rep in enumerate(self.replicas):
            if not self._serving(idx) or not rep._has_work():
                continue
            if (self.faults is not None
                    and self.faults.fire(f"dispatch:{idx}")):
                # the replica's queued work is untouched; its step
                # simply does not run
                self._on_dispatch_error(idx)
                continue
            out = rep.step(draining=draining)
            h = self._health[idx]
            h.consecutive_errors = 0
            h.backoff = 0
            done.extend(self._retag(idx, out))
        self._steal()
        self._roll_up()
        return sorted(done, key=lambda r: r.rid)

    def run(self) -> list[FinishedRequest]:
        """Drain every replica step-wise (each sees a blocking drain's
        boundaries, ``draining=True``); finished requests by fleet
        rid."""
        done: list[FinishedRequest] = []
        while any(r._has_work() for r in self.replicas):
            done.extend(self.step(draining=True))
        self._roll_up()
        return sorted(done, key=lambda r: r.rid)

    def _roll_up(self) -> None:
        self.stats.totals = sum_stats([r.stats for r in self.replicas])

    @property
    def load(self) -> int:
        return sum(r.load for r in self.replicas)


__all__ = ["FleetStats", "ReplicaRouter", "sum_stats"]
