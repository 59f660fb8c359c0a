"""QoS policy for the HTTP front door (the port of ray_tpu/serve/qos.py;
no JAX in either, so line for line but for the package).

Three concerns, all decided BEFORE a request holds any decode
resources:

- **API-key -> tenant resolution.** The gateway's ``Authorization:
  Bearer <key>`` header maps onto the multi-tenant LoRA tenant id
  (serve/lora.py); the tenant then flows through the router's
  per-tenant accounting, adapter affinity and namespace-keyed KV exactly
  as an in-process ``generate(tenant=...)`` call would.

- **Per-tenant token-bucket rate limits and quotas.** A refill-at-
  ``rate_rps`` bucket bounds the sustained request rate (``burst``
  absorbs spikes); ``max_inflight`` bounds concurrency; ``max_requests``
  is a lifetime quota fed by the SAME per-tenant accounting the router
  keeps (``DisaggRouter.tenant_stats()`` dispatched counts), so a tenant
  cannot reset its quota by reconnecting through a fresh gateway
  replica. Every rejection raises the serving plane's one shed type,
  :class:`RequestShedError` with cause ``rate_limit`` or ``quota``,
  which the gateway maps to HTTP 429 + ``Retry-After``.

- **Priority classes.** ``interactive`` (latency-bound; may preempt a
  batch-tier decode slot through the router's cancel + replay-with-
  history) and ``batch`` (throughput traffic; preemptible). A request
  names its class (``priority`` body field / ``X-Priority`` header); the
  tenant's policy supplies the default.

This module also holds the gateway's telemetry: the ``ray_tpu_gateway_*``
family on ``util.metrics`` (JAX's names, help strings, tags and
histogram boundaries, created on first use) and the best-effort pushes
to the conductor, so serve/disagg.py counts preemptions into the same
surface without importing the gateway.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .handle import RequestShedError

INTERACTIVE = "interactive"
BATCH = "batch"
CLASSES = (INTERACTIVE, BATCH)


def shed_outcome(e: RequestShedError) -> tuple:
    """Map a shed's cause onto the flight recorder's outcome vocabulary
    (observability/requests.py): deadline, disconnect and preempt each
    get their own tail-retention class; everything else (rate_limit /
    quota / capacity / failover) is a plain ``shed``."""
    cause = getattr(e, "cause", None)
    outcome = {"deadline": "deadline",
               "disconnect": "disconnect",
               "preempt": "preempt",
               "preempted": "preempt"}.get(cause, "shed")
    return outcome, cause

# ------------------------------------------------------------- telemetry


_metrics: Optional[Dict[str, Any]] = None
_metrics_lock = threading.Lock()


def gateway_metrics() -> Dict[str, Any]:
    """The gateway's metric family on ``util.metrics``, built on first
    use (importing this module registers nothing)."""
    global _metrics
    if _metrics is not None:
        return _metrics
    with _metrics_lock:
        if _metrics is None:
            from ..util.metrics import Counter, Histogram

            m = {
                "requests": Counter(
                    "ray_tpu_gateway_requests_total",
                    "HTTP requests by route, priority class, and "
                    "status code",
                    tag_keys=("route", "class", "code")),
                "ttft_ms": Histogram(
                    "ray_tpu_gateway_ttft_ms",
                    "ms from accept to first byte written, by class",
                    boundaries=[1, 5, 10, 25, 50, 100, 250, 500,
                                1000, 2500, 5000, 10000],
                    tag_keys=("class",)),
                "rate_limited": Counter(
                    "ray_tpu_gateway_rate_limited_total",
                    "requests rejected by the QoS gate, by tenant",
                    tag_keys=("tenant",)),
                "preemptions": Counter(
                    "ray_tpu_gateway_preemptions_total",
                    "batch-tier decode slots preempted by "
                    "interactive requests"),
            }
            # rebound once, fully built: a reader never sees half a dict
            _metrics = m
    return _metrics


def _worker():
    from .._private import worker as worker_mod

    return worker_mod.global_worker


def push_gateway_stats(component_id: str, stats: Dict[str, Any]) -> None:
    """Best-effort snapshot push to the conductor's gateway roster
    (``util.state.gateway_status()`` reads it); nothing without a
    cluster."""
    try:
        w = _worker()
        if w is None:
            return
        w.conductor.notify("report_gateway_stats", w.worker_id,
                           str(component_id), stats)
    except Exception:  # noqa: BLE001 — telemetry only
        pass


def push_gateway_event(event: Dict[str, Any]) -> None:
    """Best-effort instant marker (accept / first_byte / preempt /
    rate_limit / disconnect) for the merged timeline's gateway lane."""
    try:
        w = _worker()
        if w is None:
            return
        w.conductor.notify("report_gateway_event", dict(event))
    except Exception:  # noqa: BLE001 — telemetry only
        pass


# ------------------------------------------------------------ the gate

class TokenBucket:
    """Refill-at-``rate_rps`` token bucket with ``burst`` capacity.

    ``try_acquire`` returns 0.0 on success (one token consumed) or the
    seconds until a token WILL exist: the Retry-After the caller should
    surface. Time is injectable (``now``) for tests."""

    def __init__(self, rate_rps: float, burst: Optional[float] = None):
        self.rate_rps = float(rate_rps)
        self.burst = float(burst if burst is not None
                           else max(1.0, self.rate_rps))
        self._tokens = self.burst
        self._stamp: Optional[float] = None
        self._lock = threading.Lock()

    def try_acquire(self, cost: float = 1.0,
                    now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if self._stamp is not None and self.rate_rps > 0:
                self._tokens = min(
                    self.burst,
                    self._tokens + (now - self._stamp) * self.rate_rps)
            self._stamp = now
            if self._tokens >= cost:
                self._tokens -= cost
                return 0.0
            if self.rate_rps <= 0:
                return 60.0  # zero-rate tenant: effectively blocked
            return (cost - self._tokens) / self.rate_rps


@dataclass
class TenantPolicy:
    """One tenant's front-door contract. ``None`` fields are unlimited;
    ``priority`` is the DEFAULT class when the request names none."""

    rate_rps: Optional[float] = None
    burst: Optional[float] = None
    max_inflight: Optional[int] = None
    max_requests: Optional[int] = None
    priority: str = INTERACTIVE

    def __post_init__(self):
        if self.priority not in CLASSES:
            raise ValueError(
                f"unknown priority class {self.priority!r}; "
                f"expected one of {CLASSES}")


_ANON = "_anonymous"


class QosGate:
    """Admission policy the gateway evaluates before a request touches
    the router: resolve the tenant, check its bucket and quotas, pick its
    class. Thread-safe; one gate serves every handler (and N gateway
    replicas when they share a process).

    ``router`` (optional, a DisaggRouter) feeds the lifetime quota from
    the router's own per-tenant dispatched counter, so the quota survives
    gateway restarts."""

    def __init__(self,
                 api_keys: Optional[Dict[str, str]] = None,
                 policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 router: Any = None):
        self._api_keys = dict(api_keys or {})
        self._policies = dict(policies or {})
        self._default = default_policy or TenantPolicy()
        self._router = router
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._inflight: Dict[str, int] = {}
        self._admitted: Dict[str, int] = {}
        self._rejected: Dict[str, Dict[str, int]] = {}
        self._stats = {"admitted": 0, "rate_limited": 0,
                       "quota_exceeded": 0}

    # ------------------------------------------------------- resolution

    def resolve(self, api_key: Optional[str] = None,
                tenant: Optional[str] = None) -> Optional[str]:
        """API key -> tenant. With a key table configured, an unknown key
        is an authentication failure (the gateway's 401); with no table,
        the explicit tenant hint (X-Tenant header / OpenAI ``user``
        field) passes through."""
        if api_key:
            mapped = self._api_keys.get(api_key)
            if mapped is not None:
                return mapped
            if self._api_keys:
                raise PermissionError("unknown API key")
        return tenant

    def policy(self, tenant: Optional[str]) -> TenantPolicy:
        if tenant is not None and tenant in self._policies:
            return self._policies[tenant]
        return self._default

    def classify(self, tenant: Optional[str],
                 requested: Optional[str] = None) -> str:
        """The request's priority class: its own ask when valid, else the
        tenant policy's default. An unknown ask raises ValueError (the
        gateway's 400)."""
        if requested:
            if requested not in CLASSES:
                raise ValueError(
                    f"unknown priority class {requested!r}; expected "
                    f"one of {CLASSES}")
            return requested
        return self.policy(tenant).priority

    # -------------------------------------------------------- admission

    def _key(self, tenant: Optional[str]) -> str:
        return tenant if tenant is not None else _ANON

    def admit(self, tenant: Optional[str],
              cls: str = INTERACTIVE) -> None:
        """Charge one request against the tenant's bucket and quotas;
        raises :class:`RequestShedError` (cause ``rate_limit`` |
        ``quota``) on rejection. A successful admit is paired with
        :meth:`release`."""
        pol = self.policy(tenant)
        key = self._key(tenant)
        router_used = 0
        if pol.max_requests is not None and self._router is not None \
                and tenant is not None:
            try:
                router_used = int(self._router.tenant_stats()
                                  .get(tenant, {})
                                  .get("dispatched", 0))
            except Exception:  # noqa: BLE001 — accounting is advisory
                router_used = 0
        cause = None
        retry_after = 1.0
        with self._lock:
            if pol.max_requests is not None and \
                    max(self._admitted.get(key, 0),
                        router_used) >= pol.max_requests:
                cause = "quota"
                msg = (f"tenant {key!r}: lifetime request quota "
                       f"{pol.max_requests} exhausted")
                self._stats["quota_exceeded"] += 1
            elif pol.max_inflight is not None and \
                    self._inflight.get(key, 0) >= pol.max_inflight:
                cause = "quota"
                msg = (f"tenant {key!r}: max_inflight "
                       f"{pol.max_inflight} reached")
                self._stats["quota_exceeded"] += 1
            elif pol.rate_rps is not None:
                bucket = self._buckets.get(key)
                if bucket is None:
                    bucket = TokenBucket(pol.rate_rps, pol.burst)
                    self._buckets[key] = bucket
                wait = bucket.try_acquire()
                if wait > 0:
                    cause = "rate_limit"
                    retry_after = max(wait, 0.05)
                    msg = (f"tenant {key!r}: rate limit "
                           f"{pol.rate_rps:g} req/s exceeded")
                    self._stats["rate_limited"] += 1
            if cause is None:
                self._inflight[key] = self._inflight.get(key, 0) + 1
                self._admitted[key] = self._admitted.get(key, 0) + 1
                self._stats["admitted"] += 1
                return
            rej = self._rejected.setdefault(key, {})
            rej[cause] = rej.get(cause, 0) + 1
        # a rejection's side effects run outside the lock: overload must
        # not serialize healthy admissions behind a push
        gateway_metrics()["rate_limited"].inc(tags={"tenant": key})
        push_gateway_event({"kind": "rate_limit", "tenant": key,
                            "cause": cause, "class": cls,
                            "retry_after_s": round(retry_after, 3)})
        raise RequestShedError(msg, retry_after_s=retry_after,
                               cause=cause)

    def release(self, tenant: Optional[str]) -> None:
        key = self._key(tenant)
        with self._lock:
            n = self._inflight.get(key, 0)
            if n > 0:
                self._inflight[key] = n - 1

    # ---------------------------------------------------------- surface

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            tenants = {}
            for key in (set(self._admitted) | set(self._inflight)
                        | set(self._rejected)):
                tenants[key] = {
                    "admitted": self._admitted.get(key, 0),
                    "inflight": self._inflight.get(key, 0),
                    "rejected": dict(self._rejected.get(key, {})),
                }
            return dict(self._stats, tenants=tenants)


__all__ = ["BATCH", "CLASSES", "INTERACTIVE", "QosGate", "TenantPolicy",
           "TokenBucket", "gateway_metrics", "push_gateway_event",
           "push_gateway_stats", "shed_outcome"]
