"""Failure-domain tracking and quarantine (the port's copy of the JAX
package's resilience/domains.py, which imports no JAX; unchanged).

Fleets fail along hardware boundaries — a host with a flaky NIC or a
marginal card kills every gang scheduled onto it, and the reference's
answer (restart the actor wherever the scheduler likes) lets one bad
host kill the same job five times in a row. The tracker keeps a decayed
failure score per domain (host/slice); domains over the threshold are
*quarantined* — excluded from lease grants, placement-group bundle
assignment, and gang re-formation until the score decays back under the
line (or an operator clears it).

Preemptions are tracked separately as *draining*: a host that announced
a maintenance event is excluded immediately for the grace window — it is
about to disappear, scheduling onto it only manufactures failures — but
draining is not a black mark; if the host survives the window it serves
leases again with a clean score.

Pure in-memory policy, no conductor imports: the conductor owns one
instance under its lock, tests drive it with a fake clock.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class _DomainState:
    score: float = 0.0
    updated: float = 0.0
    failures: int = 0
    last_kind: str = ""
    last_detail: str = ""
    last_failure_ts: float = 0.0      # wall clock, for display
    drain_deadline: Optional[float] = None  # monotonic; None = not draining
    drain_reason: str = ""
    manual: bool = False              # operator quarantine, no decay out
    tripped: bool = False             # score crossed the threshold
    trips: int = 0                    # not-tripped -> tripped transitions
    recent: List[Dict[str, Any]] = field(default_factory=list)


class FailureDomainTracker:
    """Decayed per-domain failure scores with a quarantine threshold.

    `record` adds `weight` to the domain's score; scores halve every
    `half_life_s`, so an ancient incident cannot quarantine a healthy
    host while a burst of failures crosses the threshold fast.

    Quarantine has hysteresis: crossing the threshold trips the latch,
    and the domain stays quarantined until the score decays below HALF
    the threshold (one half-life after the last trip) — without it, a
    score of exactly-threshold would un-quarantine within a millisecond
    of decay, turning the quarantine into a coin flip.
    """

    _RECENT_KEPT = 8

    def __init__(self, threshold: float = 3.0, half_life_s: float = 600.0,
                 exempt: tuple = (),
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = float(threshold)
        self.half_life_s = max(1e-9, float(half_life_s))
        self.exempt = frozenset(exempt)
        self._clock = clock
        self._lock = threading.Lock()
        self._domains: Dict[str, _DomainState] = {}

    # ----------------------------------------------------------- mutation

    def record(self, domain: str, kind: str, weight: float = 1.0,
               detail: str = "") -> float:
        """Charge a failure against `domain`; returns the new score."""
        now = self._clock()
        with self._lock:
            st = self._domains.setdefault(domain, _DomainState(updated=now))
            st.score = self._decayed(st, now) + float(weight)
            st.updated = now
            if st.score >= self.threshold - 1e-9:
                if not st.tripped:
                    st.trips += 1  # the breaker/quarantine OPEN edge
                st.tripped = True
            st.failures += 1
            st.last_kind = kind
            st.last_detail = detail
            st.last_failure_ts = time.time()
            st.recent.append({"ts": st.last_failure_ts, "kind": kind,
                              "weight": float(weight), "detail": detail})
            del st.recent[:-self._RECENT_KEPT]
            return st.score

    def begin_drain(self, domain: str, deadline: float,
                    reason: str = "preemption") -> None:
        """Exclude `domain` until monotonic `deadline` (preemption grace
        window). Extends but never shortens an existing drain."""
        with self._lock:
            st = self._domains.setdefault(
                domain, _DomainState(updated=self._clock()))
            if st.drain_deadline is None or deadline > st.drain_deadline:
                st.drain_deadline = deadline
                st.drain_reason = reason

    def quarantine(self, domain: str, reason: str = "manual") -> None:
        """Operator pin: quarantined regardless of score until cleared."""
        now = self._clock()
        with self._lock:
            st = self._domains.setdefault(domain, _DomainState(updated=now))
            st.manual = True
            st.last_kind = reason

    def clear(self, domain: str) -> bool:
        """Forgive a domain: drop score, drain, and manual pin."""
        with self._lock:
            return self._domains.pop(domain, None) is not None

    # ------------------------------------------------------------ queries

    def _decayed(self, st: _DomainState, now: float) -> float:
        return st.score * 0.5 ** ((now - st.updated) / self.half_life_s)

    def score(self, domain: str) -> float:
        now = self._clock()
        with self._lock:
            st = self._domains.get(domain)
            return self._decayed(st, now) if st is not None else 0.0

    def is_quarantined(self, domain: str) -> bool:
        now = self._clock()
        with self._lock:
            st = self._domains.get(domain)
            if st is None:
                return False
            if st.manual:
                # an operator pin beats the exemption: exempt only
                # guards against AUTO-quarantine (score trips)
                return True
            if domain in self.exempt:
                return False
            if st.tripped and self._decayed(st, now) < self.threshold / 2:
                st.tripped = False  # hysteresis exit: latch released
            return st.tripped

    def trip_count(self, domain: Optional[str] = None) -> int:
        """Quarantine-latch OPEN transitions for one domain (or summed
        over all) — the serving self-healer reports this as its
        circuit-breaker trip counter."""
        with self._lock:
            if domain is not None:
                st = self._domains.get(domain)
                return st.trips if st is not None else 0
            return sum(st.trips for st in self._domains.values())

    def is_draining(self, domain: str) -> bool:
        now = self._clock()
        with self._lock:
            st = self._domains.get(domain)
            return (st is not None and st.drain_deadline is not None
                    and now < st.drain_deadline)

    def is_excluded(self, domain: str) -> bool:
        """Quarantined OR draining — the scheduler's single question."""
        return self.is_quarantined(domain) or self.is_draining(domain)

    def excluded(self) -> List[str]:
        with self._lock:
            names = list(self._domains)
        return [d for d in names if self.is_excluded(d)]

    def status(self) -> Dict[str, Any]:
        """Full view for the state API / dashboard."""
        now = self._clock()
        out: Dict[str, Any] = {"threshold": self.threshold,
                               "half_life_s": self.half_life_s,
                               "domains": {}}
        with self._lock:
            items = list(self._domains.items())
        for domain, st in items:
            drain_left = None
            if st.drain_deadline is not None:
                drain_left = max(0.0, st.drain_deadline - now)
            out["domains"][domain] = {
                "score": round(self._decayed(st, now), 4),
                "failures": st.failures,
                "trips": st.trips,
                "quarantined": self.is_quarantined(domain),
                "draining": drain_left is not None and drain_left > 0,
                "drain_remaining_s": drain_left,
                "drain_reason": st.drain_reason or None,
                "manual": st.manual,
                "exempt": domain in self.exempt,
                "last_kind": st.last_kind or None,
                "last_detail": st.last_detail or None,
                "last_failure_ts": st.last_failure_ts or None,
                "recent": list(st.recent),
            }
        return out
