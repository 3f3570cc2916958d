"""Deterministic fault injection for the serving fleet (mirror of
``repro.launch.faults``).

One ``FaultInjector`` is threaded through the stack and consulted at
named sites:

  ============== =====================================================
  site           effect when it fires
  ============== =====================================================
  ``alloc``      ``BlockAllocator.alloc`` raises ``KVPoolError``
                 (through ``fault_hook``): begin / ensure / restore
                 roll back atomically
  ``evict_storm``the paged server force-evicts every cached block at a
                 segment boundary (prefix index flushed)
  ``stage_stall``one staging round is skipped
  ``dispatch:i`` the router's dispatch to replica ``i`` raises
                 ``ReplicaDispatchError``: quarantine and exponential
                 backoff (the replica's queued work is untouched)
  ============== =====================================================

Two triggering modes compose: ``rates={"alloc": 0.05, ...}`` draws a
seeded Bernoulli per consultation (``np.random.RandomState``: the draws
are a pure function of the seed and the order of consultation, so a
seeded run replays exactly and fires where the JAX package's injector
fires; a rate keyed ``"dispatch"`` covers every ``dispatch:i``), and
``script={"alloc": [3, 7]}`` fires on exactly the N-th consultation of
a site (1-based). ``max_per_site`` bounds the Bernoulli firings so a
drain terminates even at rate 1.0.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


class ReplicaDispatchError(RuntimeError):
    """An injected failure dispatching work to a replica."""


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One injected fault: which site, on which consultation of it."""

    site: str
    call: int


class FaultInjector:
    """Seeded, site-addressed fault source (see the module docstring)."""

    def __init__(self, seed: int = 0, *,
                 rates: dict[str, float] | None = None,
                 script: dict[str, list[int]] | None = None,
                 max_per_site: int | None = None) -> None:
        self._rng = np.random.RandomState(seed)
        self.rates = dict(rates or {})
        self.script = {k: set(v) for k, v in (script or {}).items()}
        self.max_per_site = max_per_site
        self.calls: collections.Counter = collections.Counter()
        self.injected: collections.Counter = collections.Counter()
        self.log: list[FaultRecord] = []

    @staticmethod
    def _base(site: str) -> str:
        return site.split(":", 1)[0]

    def fire(self, site: str) -> bool:
        """Consult the injector at ``site``; True = inject the fault."""
        self.calls[site] += 1
        n = self.calls[site]
        hit = False
        if n in self.script.get(site, ()):
            hit = True
        else:
            rate = self.rates.get(site)
            if rate is None:
                rate = self.rates.get(self._base(site), 0.0)
            if rate > 0.0 and self._rng.rand() < rate:
                budget = self.max_per_site
                if budget is None or self.injected[site] < budget:
                    hit = True
        if hit:
            self.injected[site] += 1
            self.log.append(FaultRecord(site, n))
        return hit

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())


__all__ = ["FaultInjector", "FaultRecord", "ReplicaDispatchError"]
