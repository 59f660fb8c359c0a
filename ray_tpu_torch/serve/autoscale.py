"""SLO-driven autoscaler and tier self-healer for disaggregated serving
(port of ray_tpu/serve/autoscale.py).

Prefill and decode saturate on different signals and scale
independently:

- **prefill** is compute-bound burst work: its saturation shows as
  queueing delay ahead of the first token, recent p99 TTFT against the
  target SLO, discounted by the prefix-cache hit rate (a hit-heavy
  window prefills only suffixes and needs fewer prefill replicas).
- **decode** is memory-bound steady work: its saturation is free-slot
  exhaustion, and a backlog past the tier's capacity.

Pieces:

- ``SlidingWindow``: trailing-window samples -> recent p50 / p99, so the
  policy reads recent percentiles, not lifetime ones.
- ``ScalingPolicy``: hysteresis and cooldown around a desired count
  (scale up only after the pressure held for ``up_delay_s``, down after
  ``down_delay_s``, nothing within ``cooldown_s`` of the last change).
- ``DisaggPolicy``: a signals snapshot -> desired per-tier counts, with
  the decode backlog discounted by the measured speculation factor.
- ``DisaggAutoscaler``: the loop. Scale-up builds a replica through the
  tier's ``TierSpec.factory`` and registers it with the router; scale-down
  drains (``begin_drain``: dispatch stops, in-flight requests finish and
  KV transfers are acked), then the replica's ``prepare_for_shutdown``
  runs before an actor replica is killed. No in-flight request is dropped
  by a scale-down.

The loop also heals the tiers: ``watch()`` subscribes to the conductor's
``actor_state`` channel for its actor replicas. A death is not load and
bypasses hysteresis: the corpse is removed from the router
(``remove_dead``) and a replacement is built through the tier's factory.
A per-host breaker (``resilience.domains.FailureDomainTracker``) stops
replacing replicas that die repeatedly on one host; a replica that dies
mid-drain is reaped and its drain record finalized. ``replica_death``,
``replace`` and ``breaker_trip`` go to the resilience log's servefault
slice; ``scale_up`` / ``drain`` / ``scale_down`` / ``scale_from_zero``
markers to the conductor's autoscale log (the timeline's ``autoscale``
lane), drains mirrored into the resilience lane as ``serve_drain``.

Where the port differs: the JAX package's knobs are arguments with its
defaults: ``RAY_TPU_AUTOSCALE_UP_DELAY_S`` (``up_delay_s``, 2.0),
``_DOWN_DELAY_S`` (``down_delay_s``, 10.0), ``_COOLDOWN_S``
(``cooldown_s``, 5.0), ``_INTERVAL_S`` (``interval_s``, 1.0),
``_DRAIN_GRACE_S`` (``drain_grace_s``, 30.0), ``_WINDOW_S``
(``window_s`` of the autoscaler's free-slot probes and of the router's
windows, 30.0),
``_TARGET_P99_MS`` (1500.0), ``RAY_TPU_SERVE_BREAKER_THRESHOLD``
(``DisaggAutoscaler(breaker_threshold=)``, 3.0) and
``RAY_TPU_SERVE_BREAKER_WINDOW_S`` (``breaker_window_s``, 60.0).
``autoscale_metrics()`` is the ``ray_tpu_autoscale_*`` family on
``util.metrics`` (``util.state.prometheus_metrics()``); the conductor
aggregates the loops' snapshots (``util.state.autoscaler_status()``).
The CLI and dashboard surfaces wait for their port (ROADMAP Queue 1).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..observability.step_timer import percentile

_SEQ = itertools.count()

TIERS = ("prefill", "decode")

# the JAX package's knob defaults
TARGET_P99_MS = 1500.0   # the serving SLO the loop closes on: p99 TTFT, ms
WINDOW_S = 30.0
UP_DELAY_S = 2.0
DOWN_DELAY_S = 10.0
COOLDOWN_S = 5.0
INTERVAL_S = 1.0
DRAIN_GRACE_S = 30.0
BREAKER_THRESHOLD = 3.0
BREAKER_WINDOW_S = 60.0


# ------------------------------------------------------ prometheus (lazy)

_metrics: Optional[Dict[str, Any]] = None
_metrics_lock = threading.Lock()


def autoscale_metrics() -> Dict[str, Any]:
    """The ``ray_tpu_autoscale_*`` family on ``util.metrics`` (JAX's
    names, help and tags), created on first use."""
    global _metrics
    m = _metrics
    if m is not None:
        return m
    with _metrics_lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge

            _metrics = dict(
                target=Gauge(
                    "ray_tpu_autoscale_target_replicas",
                    "replica count the autoscaler is currently driving "
                    "a tier toward",
                    tag_keys=("tier",)),
                decisions=Counter(
                    "ray_tpu_autoscale_decisions_total",
                    "scale decisions taken (direction=up|down)",
                    tag_keys=("tier", "direction")),
                replica_seconds=Counter(
                    "ray_tpu_autoscale_replica_seconds_total",
                    "cumulative live replica-seconds per tier (the "
                    "provisioning cost the policy is minimizing)",
                    tag_keys=("tier",)))
    return _metrics


# --------------------------------------------------------- sliding window

class SlidingWindow:
    """Trailing-window scalar samples -> recent summary. Samples older
    than ``window_s`` age out; ``max_samples`` bounds memory."""

    def __init__(self, window_s: float = WINDOW_S, max_samples: int = 2048):
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: List[Tuple[float, float]] = []  # (ts, value)

    def add(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, float(value)))
            if len(self._samples) > self.max_samples:
                del self._samples[:len(self._samples) - self.max_samples]

    def _values(self, now: Optional[float]) -> List[float]:
        now = time.monotonic() if now is None else now
        horizon = now - self.window_s
        with self._lock:
            i = 0
            while i < len(self._samples) and self._samples[i][0] < horizon:
                i += 1
            if i:
                del self._samples[:i]
            return [v for _, v in self._samples]

    def summary(self, now: Optional[float] = None) -> Dict[str, Any]:
        """{"n", "mean", "p50", "p99", "last"} over the live window
        ({"n": 0} when empty: no evidence, never zero)."""
        vals = self._values(now)
        if not vals:
            return {"n": 0}
        ordered = sorted(vals)
        return {"n": len(vals), "mean": sum(vals) / len(vals),
                "p50": percentile(ordered, 0.5),
                "p99": percentile(ordered, 0.99), "last": vals[-1]}


# --------------------------------------------------------- policy engine

class ScalingPolicy:
    """Hysteresis + cooldown around a desired-replicas signal: the clock
    toward scaling up runs only while desired > current (any tick at or
    below resets it, and likewise for down), so a transient burst never
    scales and an oscillating signal never flaps; ``cooldown_s`` freezes
    the tier after any change."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 up_delay_s: float = UP_DELAY_S,
                 down_delay_s: float = DOWN_DELAY_S,
                 cooldown_s: float = COOLDOWN_S):
        if max_replicas < max(1, min_replicas):
            raise ValueError(
                f"invalid replica bounds [{min_replicas}, {max_replicas}]")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_delay_s = float(up_delay_s)
        self.down_delay_s = float(down_delay_s)
        self.cooldown_s = float(cooldown_s)
        # the last instant the tier was NOT under up / down pressure (None
        # until the first decide(), so injected clocks and the real one
        # never mix)
        self._calm_up: Optional[float] = None
        self._calm_down: Optional[float] = None
        self._last_change: Optional[float] = None

    def clamp(self, n: int) -> int:
        return min(max(int(n), self.min_replicas), self.max_replicas)

    def decide(self, desired: int, current: int,
               now: Optional[float] = None) -> int:
        """The new target (== current when the gates hold it back)."""
        now = time.monotonic() if now is None else now
        desired = self.clamp(desired)
        if self._calm_up is None:
            self._calm_up = self._calm_down = now
        if desired <= current:
            self._calm_up = now
        if desired >= current:
            self._calm_down = now
        in_cooldown = (self._last_change is not None
                       and now - self._last_change < self.cooldown_s)
        if desired > current and not in_cooldown \
                and now - self._calm_up >= self.up_delay_s:
            self._last_change = now
            self._calm_up = self._calm_down = now
            return desired
        if desired < current and not in_cooldown \
                and now - self._calm_down >= self.down_delay_s:
            self._last_change = now
            self._calm_up = self._calm_down = now
            return desired
        return current


class DisaggPolicy:
    """Signals -> desired replica counts, one tier at a time. Every key of
    the snapshot is optional (missing evidence never scales up):
    ``ttft_p99_ms``, ``cache_hit_rate``, ``prefill_inflight_p99`` (the
    router's windows), ``decode_free_p50`` / ``decode_busy_p99`` /
    ``decode_cap_per_replica`` (the loop's free-slot probes),
    ``queue_depth_p99`` and ``spec_tokens_per_verify`` (the decode tier's
    mean tokens per verify step: queued demand is divided by it, busy
    slots are not; absent or <= 1 changes nothing)."""

    # scale down only when the recent demand fits one fewer replica at
    # this utilization
    low_util = 0.7
    # prefill scale-down also wants the SLO comfortably met...
    down_ratio = 0.5
    # ...and a hit-heavy cache (or an idle tier)
    hit_floor = 0.5

    def __init__(self, target_p99_ms: float = TARGET_P99_MS,
                 prefill_policy: Optional[ScalingPolicy] = None,
                 decode_policy: Optional[ScalingPolicy] = None):
        self.target_p99_ms = float(target_p99_ms)
        self.policies = {"prefill": prefill_policy or ScalingPolicy(),
                         "decode": decode_policy or ScalingPolicy()}

    def desired_decode(self, signals: Dict[str, Any],
                       current: int) -> Tuple[int, str]:
        free_p50 = signals.get("decode_free_p50")
        busy_p99 = signals.get("decode_busy_p99")
        depth_p99 = signals.get("queue_depth_p99")
        cap = max(1, int(signals.get("decode_cap_per_replica", 1)))
        capacity = current * cap
        factor = max(1.0, float(signals.get("spec_tokens_per_verify")
                                or 0.0))
        eff_depth = depth_p99 / factor if depth_p99 is not None else None
        if eff_depth is not None and eff_depth > capacity:
            # a backlog past twice one replica's capacity jumps straight
            # to the count that holds it
            desired = current + 1
            if eff_depth > 2 * cap:
                desired = max(desired, -(-int(eff_depth) // cap))
            return desired, (
                f"backlog p99 {depth_p99:.0f}"
                + (f" (/{factor:.2f} speculation -> {eff_depth:.0f})"
                   if factor > 1.0 else "")
                + f" past tier capacity {capacity}"
                + (f" (proportional step -> {desired})"
                   if desired > current + 1 else ""))
        if free_p50 is not None and free_p50 <= 0:
            return current + 1, "decode slots exhausted (free p50 = 0)"
        # slot demand: the worse of busy slots and the (discounted)
        # backlog. At current == 1 this reduces to demand == 0: an idle
        # tier may drain to zero, which min_replicas clamps back.
        demand = max((v for v in (busy_p99, eff_depth) if v is not None),
                     default=None)
        if current > 0 and demand is not None \
                and demand <= self.low_util * (current - 1) * cap:
            return current - 1, (
                f"slot demand p99 {demand:.1f} fits in {current - 1} "
                f"replica(s) at {self.low_util:.0%} utilization")
        return current, "steady"

    def desired_prefill(self, signals: Dict[str, Any],
                        current: int) -> Tuple[int, str]:
        ttft_p99 = signals.get("ttft_p99_ms")
        hit_rate = signals.get("cache_hit_rate")
        inflight_p99 = signals.get("prefill_inflight_p99")
        if current > 0 and ttft_p99 is None and inflight_p99 is None:
            # a request window with no samples at all: nothing needed
            # prefill for a whole window
            return current - 1, "tier idle (no requests in the window)"
        if ttft_p99 is not None and ttft_p99 > self.target_p99_ms:
            return current + 1, (
                f"TTFT p99 {ttft_p99:.0f}ms over target "
                f"{self.target_p99_ms:.0f}ms (queueing delay)")
        if current > 1 and ttft_p99 is not None \
                and ttft_p99 < self.down_ratio * self.target_p99_ms:
            hit_heavy = hit_rate is not None and hit_rate >= self.hit_floor
            idle = inflight_p99 is not None and \
                inflight_p99 <= self.low_util * (current - 1)
            if hit_heavy or idle:
                why = (f"hit rate {hit_rate:.0%} — suffix-only prefills"
                       if hit_heavy else
                       f"inflight p99 {inflight_p99:.1f} fits in "
                       f"{current - 1}")
                return current - 1, (
                    f"TTFT p99 {ttft_p99:.0f}ms well under target; {why}")
        return current, "steady"

    def decide(self, signals: Dict[str, Any], current: Dict[str, int],
               now: Optional[float] = None
               ) -> Dict[str, Tuple[int, str]]:
        """{tier: (target, reason)} after hysteresis; target == current
        means hold."""
        out: Dict[str, Tuple[int, str]] = {}
        for tier, fn in (("prefill", self.desired_prefill),
                         ("decode", self.desired_decode)):
            cur = int(current[tier])
            desired, reason = fn(signals, cur)
            target = self.policies[tier].decide(desired, cur, now)
            out[tier] = (target, reason if target != cur else "hold")
        return out


# ----------------------------------------------------------- the loop

def _worker():
    from .._private import worker as worker_mod

    return worker_mod.global_worker


def _notify(method: str, *args: Any) -> None:
    from .disagg import _notify as notify

    notify(method, *args)


def _notify_event(event: Dict[str, Any]) -> None:
    """An instant marker of the autoscale lane."""
    _notify("report_autoscale_event", dict(event))


def _notify_resilience(event: Dict[str, Any]) -> None:
    """Drains, deaths, replacements and breaker trips also ride the
    resilience log (its servefault slice)."""
    _notify("report_resilience_event", dict(event))


def _resolve(value: Any) -> Any:
    """A non-blocking actor call's ref, resolved; a local value as is."""
    from .._private.object_store import ObjectRef

    if isinstance(value, ObjectRef):
        import ray_tpu_torch as rt

        return rt.get(value, timeout=30.0)
    return value


class TierSpec:
    """How one tier scales: bounds, hysteresis and the factory that builds
    a fresh replica (an in-process server or an actor handle; actor
    replicas are killed after their grace drain)."""

    def __init__(self, factory: Callable[[], Any], *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_delay_s: float = UP_DELAY_S,
                 down_delay_s: float = DOWN_DELAY_S,
                 cooldown_s: float = COOLDOWN_S):
        self.factory = factory
        self.policy = ScalingPolicy(min_replicas, max_replicas, up_delay_s,
                                    down_delay_s, cooldown_s)


class _Draining:
    __slots__ = ("tier", "rid", "since", "grace_deadline")

    def __init__(self, tier: str, rid: str, since: float, grace_s: float):
        self.tier = tier
        self.rid = rid
        self.since = since
        self.grace_deadline = since + grace_s


class DisaggAutoscaler:
    """Drives a ``DisaggRouter``'s prefill and decode replica sets toward
    the TTFT SLO. One ``tick()`` reads the signals, decides and applies;
    ``start()`` runs it every ``interval_s`` on a thread. ``now`` flows
    through every call, so tests replay load shapes without sleeping."""

    def __init__(self, router: Any, *,
                 prefill: TierSpec, decode: TierSpec,
                 policy: Optional[DisaggPolicy] = None,
                 interval_s: float = INTERVAL_S,
                 drain_grace_s: float = DRAIN_GRACE_S,
                 breaker_threshold: float = BREAKER_THRESHOLD,
                 breaker_window_s: float = BREAKER_WINDOW_S,
                 window_s: float = WINDOW_S,
                 autoscaler_id: Optional[str] = None):
        if not router.tier_replicas("prefill") \
                or not router.tier_replicas("decode"):
            raise ValueError("the autoscaler drives disagg routers "
                             "(a prefill AND a decode tier)")
        from ..resilience.domains import FailureDomainTracker

        self.router = router
        self.specs = {"prefill": prefill, "decode": decode}
        self.policy = policy or DisaggPolicy(
            prefill_policy=prefill.policy, decode_policy=decode.policy)
        self.interval_s = float(interval_s)
        self.drain_grace_s = float(drain_grace_s)
        self.autoscaler_id = autoscaler_id or \
            f"autoscale-{os.getpid()}-{next(_SEQ)}"
        self._free_win = SlidingWindow(window_s)
        self._busy_win = SlidingWindow(window_s)
        self._lock = threading.Lock()
        self._draining: List[_Draining] = []
        self._stats: Dict[str, Any] = {
            "scale_ups": {t: 0 for t in TIERS},
            "scale_downs": {t: 0 for t in TIERS},
            "drains_completed": 0,
            "drains_forced": 0,
            "drains_reaped": 0,
            "replica_seconds": {t: 0.0 for t in TIERS},
            "last_reason": {t: "" for t in TIERS},
            "deaths": {t: 0 for t in TIERS},
            "replacements": {t: 0 for t in TIERS},
            "replacements_blocked": 0,
            "breaker_trips": 0,
            "wakeups": {t: 0 for t in TIERS},
        }
        # scale-to-zero (a TierSpec with min_replicas=0): the router calls
        # the waker on the first arrival to the empty tier, single-flight
        # per tier
        self._waking: Dict[str, bool] = {t: False for t in TIERS}
        if any(self.specs[t].policy.min_replicas == 0 for t in TIERS):
            router.set_tier_waker(self._wake_tier)
        # the replacement breaker, keyed by the replicas' host: a host
        # whose replicas die repeatedly stops getting replacements until
        # the decayed score releases it
        self._breaker = FailureDomainTracker(threshold=breaker_threshold,
                                             half_life_s=breaker_window_s)
        self._watching = False
        # actor_id -> (tier, {"rid", "machine"}) of every ACTOR replica
        # under management, kept eagerly: when a death arrives the
        # router's failover may already have removed the corpse
        self._managed: Dict[str, Tuple[str, Dict[str, Any]]] = {}
        self._heals: List[threading.Thread] = []
        self._last_tick: Optional[float] = None
        self._last_push = 0.0
        self._last_sf_push = 0.0
        self._teardowns: List[threading.Thread] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        autoscale_metrics()

    # ------------------------------------------------------------ signals

    def probe_signals(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The router's windows plus a free-slot probe of the active decode
        replicas, folded into this loop's own windows."""
        from .disagg import _call

        sig = self.router.signals()
        reps = [r for r in self.router.tier_replicas("decode")
                if not r["draining"]]
        free = cap = 0
        ok = False
        # every probe is issued before any is resolved: actor replicas
        # answer concurrently
        probes = []
        for r in reps:
            try:
                probes.append((r, _call(r["target"], "free_slots",
                                        block=False)))
            except Exception:  # noqa: BLE001 — replica mid-restart
                pass
        for r, v in probes:
            try:
                free += int(_resolve(v))
                cap += int(r["cap"])
                ok = True
            except Exception:  # noqa: BLE001 — replica mid-restart
                pass
        if ok:
            self._free_win.add(free, now)
            self._busy_win.add(cap - free, now)
        free_sum = self._free_win.summary(now)
        busy_sum = self._busy_win.summary(now)
        if free_sum["n"]:
            sig["decode_free_p50"] = free_sum["p50"]
            sig["decode_busy_p99"] = busy_sum["p99"]
        if reps:
            sig["decode_cap_per_replica"] = max(
                1, int(sum(r["cap"] for r in reps) / len(reps)))
        # the measured speculation factor; replicas without speculation
        # contribute nothing
        stat_probes = []
        for r in reps:
            try:
                stat_probes.append(_call(r["target"], "stats", block=False))
            except Exception:  # noqa: BLE001 — replica mid-restart
                pass
        tpv: List[float] = []
        for v in stat_probes:
            try:
                sp = (_resolve(v) or {}).get("speculation") or {}
                if int(sp.get("spec_verify_ticks", 0)) > 0:
                    tpv.append(float(sp.get("tokens_per_verify", 0.0)))
            except Exception:  # noqa: BLE001 — replica mid-restart
                pass
        if tpv:
            sig["spec_tokens_per_verify"] = sum(tpv) / len(tpv)
        return sig

    # --------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One control-loop pass; returns the actions taken."""
        now = time.monotonic() if now is None else now
        actions: List[Dict[str, Any]] = []
        self._account_replica_seconds(now)
        self._advance_drains(now, actions)
        signals = self.probe_signals(now)
        current = {t: self._active_count(t) for t in TIERS}
        decisions = self.policy.decide(signals, current, now)
        m = autoscale_metrics()
        for tier in TIERS:
            target, reason = decisions[tier]
            # the TierSpec bounds hold whatever policy the caller gave
            target = self.specs[tier].policy.clamp(target)
            with self._lock:
                self._stats["last_reason"][tier] = reason
            m["target"].set(target, tags={"tier": tier})
            if target > current[tier]:
                actions.extend(self._scale_up(
                    tier, target - current[tier], target, reason))
            elif target < current[tier]:
                actions.extend(self._scale_down(
                    tier, current[tier] - target, target, reason, now))
        self.publish_telemetry(force=bool(actions))
        return actions

    def _active_count(self, tier: str) -> int:
        return sum(1 for r in self.router.tier_replicas(tier)
                   if not r["draining"])

    def _account_replica_seconds(self, now: float) -> None:
        if self._last_tick is not None:
            dt = max(0.0, now - self._last_tick)
            m = autoscale_metrics()
            for tier in TIERS:
                live = len(self.router.tier_replicas(tier))
                with self._lock:
                    self._stats["replica_seconds"][tier] += live * dt
                if live:
                    m["replica_seconds"].inc(live * dt, tags={"tier": tier})
        self._last_tick = now

    def _add(self, tier: str, replica: Any) -> str:
        rid = (self.router.add_prefill(replica) if tier == "prefill"
               else self.router.add_decode(replica))
        if self._watching:
            self._refresh_managed()
        return rid

    # ----------------------------------------------------------- scale up

    def _scale_up(self, tier: str, n: int, target: int,
                  reason: str) -> List[Dict[str, Any]]:
        actions = []
        for _ in range(n):
            try:
                replica = self.specs[tier].factory()
            except Exception as e:  # noqa: BLE001 — no capacity yet: the
                # next tick retries
                with self._lock:
                    self._stats["last_reason"][tier] = (
                        f"scale-up blocked: {type(e).__name__}: {e}")
                break
            rid = self._add(tier, replica)
            with self._lock:
                self._stats["scale_ups"][tier] += 1
            autoscale_metrics()["decisions"].inc(
                tags={"tier": tier, "direction": "up"})
            ev = {"kind": "scale_up", "tier": tier, "replica": rid,
                  "to": target, "reason": reason,
                  "autoscaler": self.autoscaler_id}
            _notify_event(ev)
            actions.append(ev)
        return actions

    # ------------------------------------------------------ scale to zero

    def _wake_tier(self, tier: str) -> bool:
        """The router's first-arrival-to-an-empty-tier hook: build one
        replica through the tier factory now (no hysteresis), off the
        arrival's thread, single-flight per tier. Only a min_replicas=0
        tier wakes: a tier with a floor is empty because its replicas
        died, and the self-healer (with its breaker) owns that."""
        if tier not in self.specs \
                or self.specs[tier].policy.min_replicas != 0:
            return False
        with self._lock:
            if self._waking.get(tier):
                return True
            self._waking[tier] = True

        def run() -> None:
            try:
                if self._active_count(tier) > 0:
                    return  # raced another wake or a tick's scale-up
                try:
                    replica = self.specs[tier].factory()
                except Exception as e:  # noqa: BLE001 — no capacity
                    with self._lock:
                        self._stats["last_reason"][tier] = (
                            f"wake blocked: {type(e).__name__}: {e}")
                    return
                rid = self._add(tier, replica)
                with self._lock:
                    self._stats["wakeups"][tier] += 1
                autoscale_metrics()["decisions"].inc(
                    tags={"tier": tier, "direction": "up"})
                _notify_event({"kind": "scale_from_zero", "tier": tier,
                               "replica": rid,
                               "autoscaler": self.autoscaler_id})
                self.publish_telemetry(force=True)
            finally:
                with self._lock:
                    self._waking[tier] = False

        threading.Thread(target=run, daemon=True,
                         name=f"autoscale-wake-{tier}").start()
        return True

    # --------------------------------------------------------- scale down

    def _scale_down(self, tier: str, n: int, target: int, reason: str,
                    now: float) -> List[Dict[str, Any]]:
        """Begin draining the newest active replicas. A min_replicas=0
        tier may drain its last one (the waker serves the next
        arrival)."""
        actions = []
        allow_empty = self.specs[tier].policy.min_replicas == 0
        active = [r for r in self.router.tier_replicas(tier)
                  if not r["draining"]]
        for r in list(reversed(active))[:n]:
            if not self.router.begin_drain(tier, r["rid"],
                                           allow_empty=allow_empty):
                continue
            with self._lock:
                self._draining.append(
                    _Draining(tier, r["rid"], now, self.drain_grace_s))
                self._stats["scale_downs"][tier] += 1
            autoscale_metrics()["decisions"].inc(
                tags={"tier": tier, "direction": "down"})
            ev = {"kind": "drain", "tier": tier, "replica": r["rid"],
                  "to": target, "inflight": r["inflight"],
                  "grace_s": self.drain_grace_s, "reason": reason,
                  "autoscaler": self.autoscaler_id}
            _notify_event(ev)
            _notify_resilience({"kind": "serve_drain", "name": r["rid"],
                                "tier": tier, "grace_s": self.drain_grace_s})
            actions.append(ev)
        return actions

    def _replica_drained(self, d: _Draining) -> bool:
        """No in-flight request left at the router and, for a prefill
        replica, no unacked KV transfer held (a decode replica may still
        be about to read it)."""
        from .disagg import _call

        if not self.router.drained(d.tier, d.rid):
            return False
        if d.tier != "prefill":
            return True
        rep = next((r for r in self.router.tier_replicas("prefill")
                    if r["rid"] == d.rid), None)
        if rep is None:
            return True
        try:
            return int(_call(rep["target"], "stats")
                       .get("held_transfers", 0)) == 0
        except Exception:  # noqa: BLE001 — replica already dead
            return True

    def _advance_drains(self, now: float,
                        actions: List[Dict[str, Any]]) -> None:
        """Finalize drains whose replica has nothing in flight, or whose
        grace window expired (the replica's prepare_for_shutdown still
        waits out stragglers, off the tick thread)."""
        with self._lock:
            pending = list(self._draining)
        still: List[_Draining] = []
        for d in pending:
            drained = self._replica_drained(d)
            if not drained and now < d.grace_deadline:
                still.append(d)
                continue
            self._finalize_drain(d, drained)
            ev = {"kind": "scale_down", "tier": d.tier, "replica": d.rid,
                  "drained": bool(drained),
                  "waited_s": round(now - d.since, 3),
                  "autoscaler": self.autoscaler_id}
            _notify_event(ev)
            actions.append(ev)
        finalized = [d for d in pending if d not in still]
        with self._lock:
            # drop only what this pass finalized: the death watcher may
            # have reaped records meanwhile
            self._draining = [d for d in self._draining
                              if d not in finalized]

    def _finalize_drain(self, d: _Draining, drained: bool) -> None:
        replica = self.router.remove(d.tier, d.rid)
        with self._lock:
            # the teardown kills the actor on purpose: its DEAD event must
            # not read as a death to heal
            self._managed = {aid: v for aid, v in self._managed.items()
                             if v[1]["rid"] != d.rid}
            self._stats["drains_completed" if drained
                        else "drains_forced"] += 1
        if replica is None:
            return
        t = threading.Thread(
            target=self._shutdown_replica, args=(replica, drained),
            daemon=True, name=f"autoscale-teardown-{d.rid}")
        t.start()
        self._teardowns.append(t)
        self._teardowns = [x for x in self._teardowns if x.is_alive()]

    def _shutdown_replica(self, replica: Any, drained: bool) -> None:
        """The replica-side grace drain, then release an actor: a drained
        replica returns at once, a forced one gets a last bounded
        window."""
        from .disagg import _call

        grace = 5.0 if drained else min(self.drain_grace_s, 10.0)
        try:
            _call(replica, "prepare_for_shutdown", grace)
        except Exception:  # noqa: BLE001 — replica already dead
            pass
        if getattr(getattr(replica, "stats", None), "remote",
                   None) is not None:
            try:
                import ray_tpu_torch as rt

                rt.kill(replica)
            except Exception:  # noqa: BLE001 — already gone
                pass

    # ------------------------------------------------------- self-healing

    def watch(self) -> "DisaggAutoscaler":
        """Subscribe to the conductor's actor_state channel for the
        managed actor replicas (idempotent; ``start()`` calls it). Death
        handling is event-driven: it never waits for a tick."""
        if self._watching:
            return self
        self._refresh_managed()
        w = _worker()
        if w is not None:
            w.subscribe_channel("actor_state", self._on_actor_state)
            self._watching = True
        return self

    def _refresh_managed(self) -> None:
        """actor_id -> replica identity for every actor replica the
        router holds."""
        seen = []
        for tier in TIERS:
            for r in self.router.tier_replicas(tier):
                aid = getattr(r.get("target"), "actor_id", None)
                if aid:
                    seen.append((aid, (tier, {"rid": r["rid"],
                                              "machine": r.get("machine")})))
        with self._lock:
            self._managed.update(seen)

    def unwatch(self) -> None:
        if not self._watching:
            return
        w = _worker()
        if w is not None:
            try:
                w.unsubscribe_channel("actor_state", self._on_actor_state)
            except Exception:  # noqa: BLE001 — worker shutting down
                pass
        self._watching = False

    def _on_actor_state(self, msg: Any) -> None:
        if not isinstance(msg, dict) or msg.get("state") != "DEAD":
            return
        with self._lock:
            found = self._managed.pop(msg.get("actor_id"), None)
        if found is None:
            return  # not ours, or a teardown of a drain
        # off the pubsub thread: the replacement runs the factory
        t = threading.Thread(
            target=self._handle_replica_death, args=found, daemon=True,
            name=f"autoscale-heal-{found[1]['rid']}")
        t.start()
        self._heals.append(t)
        self._heals = [x for x in self._heals if x.is_alive()]

    def _handle_replica_death(self, tier: str, rep: Dict[str, Any]) -> None:
        """One dead replica: reap the corpse (and a drain record it held),
        charge the breaker, replace through the tier factory unless the
        breaker is open. None of it goes through hysteresis."""
        from .disagg import servefault_metrics

        rid = rep["rid"]
        machine = rep.get("machine") or "unknown-host"
        self.router.remove_dead(tier, rid)
        with self._lock:
            self._stats["deaths"][tier] += 1
            still = [d for d in self._draining if d.rid != rid]
            was_draining = len(still) != len(self._draining)
            self._draining = still
            if was_draining:
                self._stats["drains_reaped"] += 1
        death_ev = {"kind": "replica_death", "tier": tier, "replica": rid,
                    "machine": machine, "was_draining": was_draining,
                    "autoscaler": self.autoscaler_id}
        _notify_event(death_ev)
        _notify_resilience(dict(death_ev))
        if was_draining:
            _notify_event({"kind": "scale_down", "tier": tier,
                           "replica": rid, "drained": False, "reaped": True,
                           "autoscaler": self.autoscaler_id})
        # the breaker's OPEN edge is the tracker's own trip counter; our
        # lock keeps two same-instant deaths from reporting one edge twice
        with self._lock:
            before = self._breaker.trip_count(machine)
            self._breaker.record(machine, "replica_death",
                                 detail=f"{tier}:{rid}")
            tripped = self._breaker.trip_count(machine) > before
            if tripped:
                self._stats["breaker_trips"] += 1
        if tripped:
            servefault_metrics()["breaker_trips"].inc()
            _notify_resilience({"kind": "breaker_trip", "host": machine,
                                "tier": tier, "replica": rid,
                                "score": round(self._breaker.score(machine),
                                               3),
                                "autoscaler": self.autoscaler_id})
        if was_draining:
            # it was being removed anyway: reap, don't replace
            self.publish_servefault(force=True)
            self.publish_telemetry(force=True)
            return
        if self._breaker.is_quarantined(machine):
            with self._lock:
                self._stats["replacements_blocked"] += 1
                self._stats["last_reason"][tier] = (
                    f"replacement blocked: breaker open for {machine} "
                    f"({self._breaker.score(machine):.1f} deaths in "
                    f"window)")
            self.publish_servefault(force=True)
            return
        self._replace(tier, rid)

    def _replace(self, tier: str, dead_rid: str) -> None:
        """A 1-for-1 replacement through the tier factory, outside
        hysteresis and cooldown."""
        from .disagg import servefault_metrics

        try:
            replica = self.specs[tier].factory()
        except Exception as e:  # noqa: BLE001 — no capacity right now
            with self._lock:
                self._stats["last_reason"][tier] = (
                    f"replacement blocked: {type(e).__name__}: {e}")
            self.publish_servefault(force=True)
            return
        rid = (self.router.add_prefill(replica) if tier == "prefill"
               else self.router.add_decode(replica))
        self._refresh_managed()
        with self._lock:
            self._stats["replacements"][tier] += 1
        servefault_metrics()["replacements"].inc(tags={"tier": tier})
        ev = {"kind": "replace", "tier": tier, "replica": rid,
              "for": dead_rid, "autoscaler": self.autoscaler_id}
        _notify_event(ev)
        _notify_resilience(dict(ev))
        self.publish_servefault(force=True)
        self.publish_telemetry(force=True)

    def servefault_stats(self) -> Dict[str, Any]:
        """The self-healer's part of the servefault surface."""
        with self._lock:
            sf: Dict[str, Any] = {
                "deaths": dict(self._stats["deaths"]),
                "replacements": dict(self._stats["replacements"]),
                "replacements_blocked": self._stats["replacements_blocked"],
                "breaker_trips": self._stats["breaker_trips"],
                "drains_reaped": self._stats["drains_reaped"],
            }
        sf.update(role="healer", autoscaler_id=self.autoscaler_id,
                  router=self.router.router_id,
                  breaker_open=self._breaker.excluded(),
                  breaker_threshold=self._breaker.threshold,
                  watching=self._watching)
        return sf

    def publish_servefault(self, force: bool = False) -> None:
        from .disagg import _push

        now = time.monotonic()
        if not force and now - self._last_sf_push < 0.5:
            return
        self._last_sf_push = now
        _push("report_servefault_stats", self.autoscaler_id,
              self.servefault_stats())

    # ------------------------------------------------------------ status

    def status(self) -> Dict[str, Any]:
        with self._lock:
            s = {
                "autoscaler_id": self.autoscaler_id,
                "router": self.router.router_id,
                "target_p99_ms": self.policy.target_p99_ms,
                "interval_s": self.interval_s,
                "drain_grace_s": self.drain_grace_s,
                "scale_ups": dict(self._stats["scale_ups"]),
                "scale_downs": dict(self._stats["scale_downs"]),
                "drains_completed": self._stats["drains_completed"],
                "drains_forced": self._stats["drains_forced"],
                "drains_reaped": self._stats["drains_reaped"],
                "deaths": dict(self._stats["deaths"]),
                "replacements": dict(self._stats["replacements"]),
                "replacements_blocked": self._stats["replacements_blocked"],
                "breaker_trips": self._stats["breaker_trips"],
                "replica_seconds": {
                    t: round(v, 3) for t, v
                    in self._stats["replica_seconds"].items()},
                "wakeups": dict(self._stats["wakeups"]),
                "last_reason": dict(self._stats["last_reason"]),
                "draining": [{"tier": d.tier, "rid": d.rid}
                             for d in self._draining],
            }
        s["breaker_open"] = self._breaker.excluded()
        s["watching"] = self._watching
        for tier in TIERS:
            reps = self.router.tier_replicas(tier)
            s[f"{tier}_replicas"] = len(reps)
            s[f"{tier}_active"] = sum(1 for r in reps if not r["draining"])
            s[f"{tier}_bounds"] = [self.specs[tier].policy.min_replicas,
                                   self.specs[tier].policy.max_replicas]
        return s

    def publish_telemetry(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_push < 0.5:
            return
        self._last_push = now
        w = _worker()
        if w is not None:
            _notify("report_autoscale_stats", w.worker_id,
                    self.autoscaler_id, self.status())

    # -------------------------------------------------------------- loop

    def start(self) -> "DisaggAutoscaler":
        self.watch()  # self-healing is event-driven, not tick-driven

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    traceback.print_exc()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-autoscale")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.unwatch()
        for t in self._heals:
            t.join(timeout=30.0)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # finalize drains in progress now: an abandoned draining replica
        # would stay registered, its engine running
        if self._draining:
            past_every_deadline = max(
                [time.monotonic()]
                + [d.grace_deadline for d in self._draining])
            self._advance_drains(past_every_deadline, [])
        for t in self._teardowns:
            t.join(timeout=self.drain_grace_s + 15.0)
        self.publish_telemetry(force=True)
        self.publish_servefault(force=True)


__all__ = ["DisaggAutoscaler", "DisaggPolicy", "ScalingPolicy",
           "SlidingWindow", "TARGET_P99_MS", "TierSpec", "WINDOW_S",
           "autoscale_metrics"]
