"""Fault-tolerance substrate: straggler watchdog (port of
``repro.ft.watchdog``; host-only, the same code).

Training's two dominant failure modes are (a) hard node loss — handled
by checkpoint/restart (checkpoint/manager.py + the auto-resume loop in
launch/train.py) — and (b) **stragglers**: a slow device or host
stretching every synchronous step. The watchdog detects (b) from the
per-step wall-time series:

  * robust statistics (median / MAD — a single 10x step doesn't poison
    the baseline the way mean/std would),
  * a step is a straggler event when t > median + z * MAD (z=6 default)
    AND t > slack * median (so tiny-absolute-jitter steps never alarm),
  * ``policy()`` escalates: OK -> WARN (log) after ``warn_after`` events
    in the window -> EVICT (recommend removing the slow host & elastic
    restart) after ``evict_after``.

The trainer (launch/train.py) consumes EVICT by checkpointing and
calling its ``on_evict`` hook. ``SegmentWatchdog`` is the serving
drain loop's non-fatal variant.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque


class Verdict(enum.Enum):
    OK = "ok"
    WARN = "warn"
    EVICT = "evict"


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float
    threshold: float


class StragglerWatchdog:
    def __init__(self, *, window: int = 64, z: float = 6.0,
                 slack: float = 1.5, warn_after: int = 2,
                 evict_after: int = 5, min_samples: int = 8) -> None:
        self.window = window
        self.z = z
        self.slack = slack
        self.warn_after = warn_after
        self.evict_after = evict_after
        self.min_samples = min_samples
        self._times: deque[float] = deque(maxlen=window)
        self._events: deque[int] = deque(maxlen=window)
        self.history: list[StragglerEvent] = []
        self._step = 0
        self._t0: float | None = None

    # -- timing API ---------------------------------------------------------
    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> Verdict:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    # -- core ---------------------------------------------------------------
    def observe(self, seconds: float) -> Verdict:
        """Feed one step time; returns the escalation verdict."""
        self._step += 1
        verdict = Verdict.OK
        if len(self._times) >= self.min_samples:
            med = _median(self._times)
            mad = _median([abs(t - med) for t in self._times]) or 1e-9
            threshold = max(med + self.z * 1.4826 * mad, self.slack * med)
            if seconds > threshold:
                self._events.append(self._step)
                self.history.append(
                    StragglerEvent(self._step, seconds, med, threshold)
                )
                n_recent = sum(
                    1 for s in self._events if s > self._step - self.window
                )
                if n_recent >= self.evict_after:
                    verdict = Verdict.EVICT
                elif n_recent >= self.warn_after:
                    verdict = Verdict.WARN
                # straggler steps don't enter the baseline
                return verdict
        self._times.append(seconds)
        return verdict

    @property
    def median_step_s(self) -> float:
        return _median(self._times) if self._times else float("nan")


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclasses.dataclass
class SegmentEvent:
    """One serving-side watchdog trip: segment ``call`` took ``seconds``
    against a trailing ``median`` (threshold = k * median)."""

    call: int
    seconds: float
    median: float
    threshold: float


class SegmentWatchdog:
    """Straggler detection for the serving drain loop: a segment
    dispatch whose wall time exceeds ``k`` x the trailing median is a
    recorded, NON-fatal event (the request still completes — the point
    is that a wedged compile, a device hang limping through retries, or
    a pathological host stall becomes observable in ``SchedulerStats``
    instead of silently stretching every SLO).

    Differences from ``StragglerWatchdog`` deliberate and small: serving
    segments legitimately span several compiled shapes (admit_k, width,
    steps all key executables), so the baseline is a plain trailing
    median with a multiplicative ``k`` — no MAD band, no escalation
    ladder, no evict verdict. Trips are excluded from the baseline so a
    stall cannot poison its own detector."""

    def __init__(self, *, k: float = 8.0, window: int = 64,
                 min_samples: int = 8) -> None:
        if k <= 1.0:
            raise ValueError(f"k must be > 1.0, got {k}")
        self.k = k
        self.min_samples = min_samples
        self._times: deque[float] = deque(maxlen=window)
        self.events: list[SegmentEvent] = []
        self._call = 0

    def observe(self, seconds: float) -> bool:
        """Feed one segment wall time; True = straggler event (recorded
        in ``events``, excluded from the baseline)."""
        self._call += 1
        if len(self._times) >= self.min_samples:
            med = _median(self._times)
            threshold = self.k * med
            if med > 0.0 and seconds > threshold:
                self.events.append(
                    SegmentEvent(self._call, seconds, med, threshold))
                return True
        self._times.append(seconds)
        return False

    @property
    def median_segment_s(self) -> float:
        return _median(self._times) if self._times else float("nan")
