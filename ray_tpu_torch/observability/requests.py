"""Per-request flight recorder (port of ray_tpu/observability/requests.py):
where one request's time went, and which phase owns the tail.

- A :class:`RequestTrace` is minted by the router (or taken over from a
  caller) under one request id, bridged to an incoming W3C
  ``traceparent``, and made the thread's current trace, so every hop
  stamps a phase without an argument threaded through its signature.
- Hops append **phases**: ``qos_admission``, ``queue_reserve`` (the
  router's admission), ``prefill``, ``kv_transfer`` (the decode
  replica's fetch and adoption), ``decode_first_token``,
  ``decode_steady`` and the gateway's ``sse_flush`` (concurrent with
  decode, so left out of the phase-sum-versus-wall invariant). A
  failover replay stamps the same phases again under its attempt
  number, children of the same request id.
- A finished trace goes to the process's :class:`RequestTraceStore`
  under **tail-based retention**: every anomalous outcome (shed, error,
  deadline, disconnect, preempt, a replay) is kept, so are the slowest
  N, and the rest with a sampling probability.
- :func:`p99_attribution` diffs each phase's mean time between the p50
  and the p99 cohorts and names the phase that owns the tail.

The store pushes its stats and every kept trace to the conductor
(``report_requesttrace_stats`` / ``report_requesttrace_event``);
``util.state.requesttrace_status()`` / ``request_trace()``, the
``ray_tpu_reqtrace_*`` Prometheus family and the merged timeline's
``requests`` lane read the same numbers.

The JAX package's knobs are the store's arguments, with its defaults:
``RequestTraceStore(enabled=True, slowest=32, sample=0.05, kept=512,
window=2048, rng=None)`` for ``RAY_TPU_REQTRACE``, ``_SLOWEST``,
``_SAMPLE``, ``_KEPT`` and ``_WINDOW``. The sampling draw takes an
explicit ``random.Random`` (``rng``). ``configure(...)`` installs a
store built from those arguments as the process's; with
``enabled=False`` every hook is a no-op.
"""
from __future__ import annotations

import heapq
import random
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

# The canonical phase order. ``sse_flush`` overlaps decode on the
# gateway's event loop, so it stays out of the phase-sum invariant.
PHASES = ("qos_admission", "queue_reserve", "prefill", "kv_transfer",
          "decode_first_token", "decode_steady", "sse_flush")
CONCURRENT_PHASES = frozenset({"sse_flush"})

# Outcomes whose traces retention always keeps.
ANOMALOUS_OUTCOMES = frozenset({"shed", "error", "deadline",
                                "disconnect", "preempt"})


def enabled() -> bool:
    """The process store's master switch (on by default)."""
    return store().enabled


def _mint_trace_id() -> str:
    return uuid.uuid4().hex  # 32 lowercase hex, the W3C trace-id width


def _mint_span_id() -> str:
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------- trace

class RequestTrace:
    """One request's phase log. Thread-safe: the gateway's event loop
    and the router's thread append to one trace concurrently."""

    def __init__(self, request_id: str, *, source: str = "router",
                 trace_id: Optional[str] = None,
                 tenant: Optional[str] = None,
                 cls: Optional[str] = None,
                 store: Optional["RequestTraceStore"] = None,
                 t0: Optional[float] = None):
        self.request_id = str(request_id)
        self.trace_id = trace_id or _mint_trace_id()
        self.span_id = _mint_span_id()
        self.source = source
        self.tenant = tenant
        self.cls = cls
        self.start_ts = time.time()
        self._t0 = time.perf_counter() if t0 is None else t0
        self._store = store
        self._lock = threading.Lock()
        self._phases: List[Dict[str, Any]] = []
        self._open: List[Dict[str, Any]] = []  # innermost last
        self._attempt = 1
        self._preempts = 0
        self._finished: Optional[Dict[str, Any]] = None

    def traceparent(self) -> str:
        """The W3C header value that carries this trace downstream (the
        wire format of util/tracing.py)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def _now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    @contextmanager
    def phase(self, name: str, **attrs: Any) -> Iterator[Dict[str, Any]]:
        """Record ``name`` over the with-block; an exception still
        records the elapsed time, with the error's type."""
        rec: Dict[str, Any] = {"phase": str(name),
                               "t_ms": round(self._now_ms(), 3)}
        if attrs:
            rec.update(attrs)
        with self._lock:
            rec["attempt"] = self._attempt
            self._open.append(rec)
        t0 = time.perf_counter()
        try:
            yield rec
        except BaseException as e:
            rec["error"] = type(e).__name__
            raise
        finally:
            rec["dur_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            with self._lock:
                if rec in self._open:
                    self._open.remove(rec)
                self._phases.append(rec)

    def add_phase(self, name: str, dur_ms: float, *,
                  t_ms: Optional[float] = None,
                  concurrent: bool = False, **attrs: Any) -> None:
        """Append a phase measured elsewhere; ``concurrent`` keeps it out
        of the phase-sum invariant."""
        dur_ms = float(dur_ms)
        rec: Dict[str, Any] = {
            "phase": str(name),
            "t_ms": round(self._now_ms() - dur_ms
                          if t_ms is None else t_ms, 3),
            "dur_ms": round(dur_ms, 3)}
        if concurrent or name in CONCURRENT_PHASES:
            rec["concurrent"] = True
        if attrs:
            rec.update(attrs)
        with self._lock:
            rec["attempt"] = self._attempt
            self._phases.append(rec)

    def annotate(self, **attrs: Any) -> None:
        """Merge attrs into the innermost open phase; numbers add up, so
        per-pull calls sum."""
        with self._lock:
            if not self._open:
                return
            top = self._open[-1]
            for k, v in attrs.items():
                if isinstance(v, (int, float)) \
                        and isinstance(top.get(k), (int, float)):
                    top[k] = top[k] + v
                else:
                    top[k] = v

    def begin_attempt(self) -> int:
        """A failover replay starts: later phases carry the new attempt
        number under the same id."""
        with self._lock:
            self._attempt += 1
            return self._attempt

    def mark_preempt(self) -> None:
        """A preemption hit this request; its replay is attempt-tagged
        like a failover and counted apart."""
        with self._lock:
            self._preempts += 1
            self._attempt += 1

    def finish(self, outcome: str, *, cause: Optional[str] = None,
               **attrs: Any) -> Optional[Dict[str, Any]]:
        """Seal the trace and hand it to the store. The first finish
        wins."""
        with self._lock:
            if self._finished is not None:
                return self._finished
            total_ms = round(self._now_ms(), 3)
            phases = [dict(p) for p in self._phases]
            phase_ms: Dict[str, float] = {}
            for p in phases:
                phase_ms[p["phase"]] = round(
                    phase_ms.get(p["phase"], 0.0)
                    + float(p.get("dur_ms", 0.0)), 3)
            rec: Dict[str, Any] = {
                "kind": "trace",
                "request_id": self.request_id,
                "trace_id": self.trace_id,
                "source": self.source,
                "ts": self.start_ts,
                "total_ms": total_ms,
                "outcome": str(outcome),
                "attempts": self._attempt,
                "replayed": self._attempt > 1,
                "preempts": self._preempts,
                "phases": phases,
                "phase_ms": phase_ms,
            }
            if cause is not None:
                rec["cause"] = str(cause)
            if self.tenant is not None:
                rec["tenant"] = self.tenant
            if self.cls is not None:
                rec["class"] = self.cls
            if attrs:
                rec.update({k: v for k, v in attrs.items()
                            if v is not None})
            self._finished = rec
        if self._store is not None:
            self._store.record(rec)
        return rec

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"request_id": self.request_id,
                    "trace_id": self.trace_id,
                    "attempt": self._attempt,
                    "phases": [dict(p) for p in self._phases]}


# ------------------------------------------------------- thread-local

_tls = threading.local()


def current_trace() -> Optional[RequestTrace]:
    return getattr(_tls, "trace", None)


@contextmanager
def activate(trace: Optional[RequestTrace]) -> Iterator[None]:
    """Make ``trace`` the thread's current trace for the block (None
    does nothing, so call sites need no branch)."""
    if trace is None:
        yield
        return
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield
    finally:
        _tls.trace = prev


@contextmanager
def phase(name: str, **attrs: Any) -> Iterator[None]:
    """Stamp a phase on the current trace; nothing without one."""
    tr = current_trace()
    if tr is None:
        yield
        return
    with tr.phase(name, **attrs):
        yield


def annotate(**attrs: Any) -> None:
    """Merge attrs into the current trace's innermost open phase;
    nothing without a trace."""
    tr = current_trace()
    if tr is not None:
        tr.annotate(**attrs)


def start_trace(request_id: Optional[str] = None, *,
                source: str = "router",
                traceparent: Optional[str] = None,
                tenant: Optional[str] = None,
                cls: Optional[str] = None,
                t0: Optional[float] = None) -> Optional[RequestTrace]:
    """Mint a trace bound to the process store, taking an incoming
    traceparent's trace id. None when the store is disabled: every hook
    takes None."""
    st = store()
    if not st.enabled:
        return None
    trace_id = None
    if traceparent:
        from ..util import tracing

        parsed = tracing._parse_traceparent(traceparent)
        if parsed:
            trace_id = parsed["trace_id"]
    return RequestTrace(request_id or f"req-{uuid.uuid4().hex[:24]}",
                        source=source, trace_id=trace_id, tenant=tenant,
                        cls=cls, store=st, t0=t0)


# -------------------------------------------------------- attribution

def p99_attribution(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Diff each phase's mean time between the p50 cohort (total at or
    below the median) and the p99 cohort (at or above the 99th
    percentile, at least the slowest request), and name the phase that
    owns the tail. Pure over compact summaries ({total_ms, phase_ms}),
    so the conductor runs it over every store's merged window."""
    rows = [s for s in summaries
            if isinstance(s.get("total_ms"), (int, float))]
    if not rows:
        return {"n": 0, "phases": {}, "tail_owner": None}
    rows = sorted(rows, key=lambda s: s["total_ms"])
    n = len(rows)
    p50_cut = rows[(n - 1) // 2]["total_ms"]
    p99_cut = rows[min(n - 1, max(0, int(0.99 * n)))]["total_ms"]
    p50 = [s for s in rows if s["total_ms"] <= p50_cut]
    p99 = [s for s in rows if s["total_ms"] >= p99_cut] or [rows[-1]]

    def _mean(cohort: List[Dict[str, Any]], ph: str) -> float:
        return sum(float((s.get("phase_ms") or {}).get(ph, 0.0))
                   for s in cohort) / len(cohort)

    names: List[str] = list(PHASES)
    for s in rows:
        for ph in (s.get("phase_ms") or {}):
            if ph not in names:
                names.append(ph)
    phases: Dict[str, Dict[str, float]] = {}
    for ph in names:
        lo, hi = _mean(p50, ph), _mean(p99, ph)
        if lo == 0.0 and hi == 0.0:
            continue
        phases[ph] = {"p50_ms": round(lo, 3), "p99_ms": round(hi, 3),
                      "delta_ms": round(hi - lo, 3)}
    tail_owner = None
    deltas = {ph: v["delta_ms"] for ph, v in phases.items()}
    if deltas:
        tail_owner = max(deltas, key=lambda ph: deltas[ph])
        if deltas[tail_owner] <= 0.0:
            tail_owner = None
    out: Dict[str, Any] = {
        "n": n,
        "p50_cohort": len(p50),
        "p99_cohort": len(p99),
        "p50_total_ms": round(float(p50_cut), 3),
        "p99_total_ms": round(float(p99_cut), 3),
        "phases": phases,
        "tail_owner": tail_owner,
    }
    if tail_owner is not None:
        gap = sum(d for d in deltas.values() if d > 0)
        out["tail_share"] = round(deltas[tail_owner] / gap, 4) \
            if gap > 0 else 0.0
    return out


# ------------------------------------------------------------ metrics

_metrics: Optional[Dict[str, Any]] = None
_metrics_lock = threading.Lock()


def reqtrace_metrics() -> Dict[str, Any]:
    """The ``ray_tpu_reqtrace_*`` family (JAX's names, help and tags),
    created on first use."""
    global _metrics
    if _metrics is not None:
        return _metrics
    with _metrics_lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge, Histogram

            _metrics = {
                "phase_ms": Histogram(
                    "ray_tpu_reqtrace_phase_ms",
                    "Per-request phase latency by phase name (ms)",
                    boundaries=[1.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                                250.0, 500.0, 1000.0, 2500.0, 5000.0,
                                10000.0],
                    tag_keys=("phase",)),
                "requests": Counter(
                    "ray_tpu_reqtrace_requests_total",
                    "Traced requests by outcome",
                    tag_keys=("outcome",)),
                "kept": Counter(
                    "ray_tpu_reqtrace_kept_total",
                    "Traces retained, by retention reason",
                    tag_keys=("reason",)),
                "dropped": Counter(
                    "ray_tpu_reqtrace_dropped_total",
                    "Completed traces not retained (sampled out)"),
                # one series per slowest-request champion, written only
                # when the champion changes
                "slowest_ms": Gauge(
                    "ray_tpu_reqtrace_slowest_ms",
                    "Slowest traced request (exemplar id in the "
                    "request_id label)",
                    tag_keys=("request_id",)),
            }
    return _metrics


# -------------------------------------------------------- conductor IO

def _worker():
    from .._private import worker as worker_mod

    return worker_mod.global_worker


def _notify(method: str, *args: Any) -> None:
    w = _worker()
    if w is None:
        return
    try:
        w.conductor.notify(method, *args)
    except Exception:  # noqa: BLE001 — telemetry only
        pass


def push_remote_phase(request_id: str, phase_name: str,
                      dur_ms: float, *, attempt: int = 1,
                      **attrs: Any) -> None:
    """A tier hop in another process (an actor's prefill or decode)
    records a child phase under the originating request id through the
    conductor; `request_trace` merges it into the kept trace."""
    if not enabled():
        return
    ev: Dict[str, Any] = {"kind": "phase", "request_id": str(request_id),
                          "phase": str(phase_name),
                          "dur_ms": round(float(dur_ms), 3),
                          "attempt": int(attempt)}
    if attrs:
        ev.update(attrs)
    _notify("report_requesttrace_event", ev)


# -------------------------------------------------------------- store

class RequestTraceStore:
    """The process's retention and aggregation of finished traces.

    Retention: an anomalous outcome is always kept; the slowest
    `slowest` are never evicted while they hold the title; every other
    trace is kept with probability `sample`, drawn from `rng`. The kept
    set holds at most `kept` traces, oldest first out, sparing the
    slowest. Compact summaries of every completion go to a window of
    `window`, so the p99 attribution sees the whole population."""

    def __init__(self, component_id: Optional[str] = None, *,
                 enabled: bool = True, slowest: int = 32,
                 sample: float = 0.05, kept: int = 512,
                 window: int = 2048,
                 rng: Optional[random.Random] = None):
        self.component_id = component_id \
            or f"reqtrace-{uuid.uuid4().hex[:8]}"
        self.enabled = bool(enabled)
        # JAX's floors on its knobs
        self.slowest_n = max(1, int(slowest))
        self.sample = float(sample)
        self.kept_cap = max(1, int(kept))
        self.window = max(16, int(window))
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._kept: Dict[str, Dict[str, Any]] = {}  # insertion-ordered
        # min-heap of the `slowest_n` largest kept totals: its root is the
        # slow bar. Eviction spares the slowest N, so only a new kept
        # trace can change it.
        self._top: List[float] = []
        self._summaries: List[Dict[str, Any]] = []
        self._seq = 0
        self._completed = 0
        self._dropped = 0
        self._outcomes: Dict[str, int] = {}
        self._replayed = 0
        self._preempted = 0
        self._slowest_ms = 0.0
        self._last_push = 0.0

    def record(self, rec: Dict[str, Any]) -> None:
        """Take in one finished trace record (`RequestTrace.finish`)."""
        outcome = str(rec.get("outcome", "ok"))
        total_ms = float(rec.get("total_ms", 0.0))
        anomalous = (outcome in ANOMALOUS_OUTCOMES
                     or bool(rec.get("replayed"))
                     or int(rec.get("preempts", 0)) > 0)
        new_champion = False
        with self._lock:
            self._seq += 1
            self._completed += 1
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
            if rec.get("replayed"):
                self._replayed += 1
            if int(rec.get("preempts", 0)) > 0:
                self._preempted += 1
            self._summaries.append({
                "seq": self._seq, "request_id": rec.get("request_id"),
                "total_ms": total_ms, "outcome": outcome,
                "phase_ms": dict(rec.get("phase_ms") or {})})
            if len(self._summaries) > self.window:
                del self._summaries[:len(self._summaries) - self.window]
            reason = None
            if anomalous:
                reason = "anomaly"
            elif len(self._kept) < self.slowest_n \
                    or total_ms >= self._slow_bar_locked():
                reason = "slowest"
            elif self._rng.random() < self.sample:
                reason = "sampled"
            if reason is None:
                self._dropped += 1
            else:
                self._keep_locked(str(rec.get("request_id")), rec, total_ms)
            if total_ms > self._slowest_ms:
                self._slowest_ms = total_ms
                new_champion = True
        m = reqtrace_metrics()
        m["requests"].inc(tags={"outcome": outcome})
        for ph, ms in (rec.get("phase_ms") or {}).items():
            m["phase_ms"].observe(float(ms), tags={"phase": ph})
        if reason is None:
            m["dropped"].inc()
        else:
            m["kept"].inc(tags={"reason": reason})
            # a kept trace rides the conductor's event log: the requests
            # lane and request_trace read it back
            _notify("report_requesttrace_event", dict(rec))
        if new_champion:
            m["slowest_ms"].set(
                total_ms, tags={"request_id": str(rec.get("request_id"))})
        self.publish_telemetry()

    def _slow_bar_locked(self) -> float:
        """The Nth-slowest kept total: a trace at or past it is kept."""
        return self._top[0] if len(self._top) >= self.slowest_n else 0.0

    def _keep_locked(self, rid: str, rec: Dict[str, Any],
                     total_ms: float) -> None:
        replaced = rid in self._kept
        self._kept[rid] = dict(rec)
        if replaced:  # a re-used id: its old total may hold the bar
            self._top = heapq.nlargest(
                self.slowest_n, (float(r.get("total_ms", 0.0))
                                 for r in self._kept.values()))
            heapq.heapify(self._top)
        elif len(self._top) < self.slowest_n:
            heapq.heappush(self._top, total_ms)
        elif total_ms > self._top[0]:
            heapq.heapreplace(self._top, total_ms)
        self._evict_locked()

    def _evict_locked(self) -> None:
        """Oldest first, sparing the current slowest N."""
        if len(self._kept) <= self.kept_cap:
            return
        protect = set(sorted(
            self._kept,
            key=lambda rid: float(self._kept[rid].get("total_ms", 0.0)),
            reverse=True)[:self.slowest_n])
        for rid in list(self._kept):
            if len(self._kept) <= self.kept_cap:
                break
            if rid in protect:
                continue
            del self._kept[rid]

    # -------------------------------------------------------- reading

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def summaries_since(self, seq: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._summaries if s["seq"] > seq]

    def trace(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._kept.get(str(request_id))
            return dict(rec) if rec else None

    def kept_ids(self) -> List[str]:
        """The ids of the kept traces, oldest first."""
        with self._lock:
            return list(self._kept)

    def slowest(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        k = self.slowest_n if k is None else int(k)
        with self._lock:
            recs = sorted(self._kept.values(),
                          key=lambda r: float(r.get("total_ms", 0.0)),
                          reverse=True)[:k]
            return [dict(r) for r in recs]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            summaries = [dict(s) for s in self._summaries]
            out: Dict[str, Any] = {
                "component_id": self.component_id,
                "completed": self._completed,
                "kept": len(self._kept),
                "dropped": self._dropped,
                "outcomes": dict(self._outcomes),
                "replayed_requests": self._replayed,
                "preempted_requests": self._preempted,
                "slowest_ms": round(self._slowest_ms, 3),
                "window": len(summaries),
            }
        out["slowest"] = [
            {"request_id": r.get("request_id"),
             "total_ms": r.get("total_ms"),
             "outcome": r.get("outcome"),
             "attempts": r.get("attempts"),
             "phase_ms": dict(r.get("phase_ms") or {})}
            for r in self.slowest()]
        out["attribution"] = p99_attribution(summaries)
        # the window's tail rides the push, so the conductor attributes
        # over every store's population
        out["recent"] = [{k: v for k, v in s.items() if k != "seq"}
                         for s in summaries[-256:]]
        return out

    def publish_telemetry(self, force: bool = False) -> None:
        """Push `stats()` to the conductor (best effort), at most every
        0.5 s unless `force`."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_push < 0.5:
                return
            self._last_push = now
        w = _worker()
        if w is None:
            return
        try:
            w.conductor.notify("report_requesttrace_stats", w.worker_id,
                               self.component_id, self.stats())
        except Exception:  # noqa: BLE001 — cluster shutting down
            pass


# ----------------------------------------------------- process store

_store: Optional[RequestTraceStore] = None
_store_lock = threading.Lock()


def store() -> RequestTraceStore:
    """The process's shared store (the router and every other recorder
    of the process keep to one retention budget)."""
    global _store
    if _store is None:
        with _store_lock:
            if _store is None:
                _store = RequestTraceStore()
    return _store


def configure(**kwargs: Any) -> RequestTraceStore:
    """Install a new process store built from `RequestTraceStore`'s
    arguments (``enabled``, ``slowest``, ``sample``, ``kept``,
    ``window``, ``rng``) and return it."""
    global _store
    new = RequestTraceStore(**kwargs)
    with _store_lock:
        _store = new
    return new


def _reset_store_for_tests() -> None:
    global _store
    with _store_lock:
        _store = None


__all__ = ["ANOMALOUS_OUTCOMES", "CONCURRENT_PHASES", "PHASES",
           "RequestTrace", "RequestTraceStore", "activate", "annotate",
           "configure", "current_trace", "enabled", "p99_attribution",
           "phase", "push_remote_phase", "reqtrace_metrics",
           "start_trace", "store"]
