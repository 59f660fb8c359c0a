"""Replica actor (the port of ray_tpu/serve/replica.py) — the
reference's python/ray/serve/_private/replica.py (ReplicaActor :231,
handle_request :390, UserCallableWrapper).

One replica = one actor with max_concurrency = max_ongoing_requests; the
queue-length it reports (num ongoing requests) drives both the pow-2
router and the controller's autoscaler, mirroring the reference's
ReplicaMetricsManager. A streamed result is pushed chunk by chunk into
the caller's stream endpoint (the worker's ``stream_chunk`` RPC), with a
synchronous push every ``_ACK_EVERY`` chunks; async methods and async
generators run on the actor's event loop (``ActorRuntime.ensure_loop``).
"""
from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Dict, List, Optional

import cloudpickle

from .context import RequestContext, set_request_context
from .http_util import Request  # noqa: F401 — re-export for user callables

# Replica-side data-plane telemetry (one set of metric objects per
# process; replicas are one-per-process so the WorkerId label already
# distinguishes them). They ride the util.metrics conductor push into
# the Prometheus text of `util.state.prometheus_metrics()`.
_metrics_cache: Dict[str, Any] = {}
_metrics_lock = threading.Lock()

_LATENCY_BOUNDS_MS = [1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0, 10000.0]


def _replica_metrics() -> Dict[str, Any]:
    # double-checked init: the unlocked read is the per-request fast
    # path; the lock only guards first-time registration so two racing
    # first requests cannot both register metric objects (duplicate
    # identical-labelset Prometheus series)
    if _metrics_cache:
        return _metrics_cache
    with _metrics_lock:
        if not _metrics_cache:
            _build_metrics()
    return _metrics_cache


def _build_metrics() -> None:
    from ..util.metrics import Counter, Gauge, Histogram

    tags = ("app", "deployment")
    _metrics_cache.update(
        latency=Histogram(
            "serve_request_latency_ms",
            "end-to-end request latency on the replica",
            boundaries=_LATENCY_BOUNDS_MS, tag_keys=tags),
        # `cache` labels prefix-cache wins (hit|partial|miss, "" for
        # streams that did not come from the batching engine) so the
        # paged KV cache shows up in the existing latency pipeline
        ttft=Histogram(
            "serve_ttft_ms",
            "time to first streamed chunk (streaming requests)",
            boundaries=_LATENCY_BOUNDS_MS, tag_keys=tags + ("cache",)),
        requests=Counter(
            "serve_requests_total", "requests handled",
            tag_keys=tags + ("outcome",)),
        inflight=Gauge(
            "serve_replica_inflight",
            "requests currently executing on this replica",
            tag_keys=tags + ("replica",)))


class HandleMarker:
    """Placeholder for a bound sub-deployment inside serialized init args;
    swapped for a live DeploymentHandle in the replica (reference: Serve
    replaces DeploymentNode args with handles at build time)."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name


def _resolve_markers(obj: Any, app_name: str) -> Any:
    from .handle import DeploymentHandle
    if isinstance(obj, HandleMarker):
        return DeploymentHandle(obj.deployment_name, app_name)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve_markers(x, app_name) for x in obj)
    if isinstance(obj, dict):
        return {k: _resolve_markers(v, app_name) for k, v in obj.items()}
    return obj


def _as_iterator(result: Any):
    """An iterator over `result` if it is a streamable producer (sync or
    async generator, or any non-container iterator); None for plain
    values. Containers (str/bytes/list/dict/...) are values, not streams."""
    import types

    if isinstance(result, types.AsyncGeneratorType):
        return _drain_async_gen(result)
    if isinstance(result, types.GeneratorType):
        return result
    if hasattr(result, "__next__"):
        return result
    return None


def _loop_runner():
    """(run, owns_loop, loop): `run(coro)` resolves a coroutine on the
    ACTOR's persistent event loop when one exists — the same loop async
    methods run on, so loop-bound primitives from async init keep
    working — else on a private loop the caller must close."""
    import asyncio

    from .._private.worker import global_worker

    runtime = getattr(global_worker, "_actor_runtime", None)
    if runtime is not None:
        loop = runtime.ensure_loop()

        def run(coro):
            return asyncio.run_coroutine_threadsafe(coro, loop).result()

        return run, False, loop
    loop = asyncio.new_event_loop()
    return loop.run_until_complete, True, loop


def _run_coro(coro, request_ctx=None):
    """Resolve one coroutine, re-applying the request context INSIDE the
    loop thread — run_coroutine_threadsafe tasks capture the loop
    thread's contextvars, not the submitting request thread's, so
    get_request_context() would otherwise read empty inside async
    methods."""
    async def with_ctx():
        token = None
        if request_ctx is not None:
            token = set_request_context(request_ctx)
        try:
            return await coro
        finally:
            if token is not None:
                from .context import _request_context

                _request_context.reset(token)

    run, owns_loop, loop = _loop_runner()
    try:
        return run(with_ctx())
    finally:
        if owns_loop:
            loop.close()


def _drain_async_gen(agen):
    """Sync iterator over an async generator (see _loop_runner for the
    loop-affinity rationale)."""
    run, owns_loop, loop = _loop_runner()
    try:
        while True:
            try:
                yield run(agen.__anext__())
            except StopAsyncIteration:
                break
    finally:
        try:
            run(agen.aclose())
        except Exception:  # noqa: BLE001 — best-effort close
            pass
        if owns_loop:
            loop.close()


class ReplicaActor:
    """Hosts the user callable (class instance or plain function)."""

    def __init__(self, replica_tag: str, deployment_name: str, app_name: str,
                 serialized_callable: bytes, init_args: bytes,
                 user_config: Optional[Any] = None):
        from .autoscale import SlidingWindow

        self.replica_tag = replica_tag
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._inflight = 0
        self._draining = False
        self._lock = threading.Lock()
        self._num_requests = 0
        self._num_errors = 0
        self._start_time = time.time()
        self._tags = {"app": app_name, "deployment": deployment_name}
        # trailing-window twins of the cumulative Prometheus histograms:
        # `serve status` (and the autoscaling signal path) read RECENT
        # p50/p99, which a lifetime histogram can't give once load
        # shifts (serve/autoscale.SlidingWindow, shared derivation)
        self._recent_latency = SlidingWindow()
        self._recent_ttft = SlidingWindow()

        target = cloudpickle.loads(serialized_callable)
        args, kwargs = cloudpickle.loads(init_args)
        args = _resolve_markers(args, app_name)
        kwargs = _resolve_markers(kwargs, app_name)
        if isinstance(target, type):
            self._callable = target(*args, **kwargs)
            self._is_function = False
        else:
            self._callable = target
            self._is_function = True
        if user_config is not None:
            self.reconfigure(user_config)

    # -- data plane ---------------------------------------------------------
    def _invoke(self, meta: Dict[str, Any], args: List[Any],
                kwargs: Dict[str, Any]) -> Any:
        """Run the user callable under the request context (no in-flight
        accounting — callers hold it for their full request lifetime)."""
        # Resolve composed DeploymentResponse refs (they arrive nested inside
        # the args list, below the depth the worker auto-resolves).
        import ray_tpu_torch as rt
        from .._private.object_store import ObjectRef
        args = [rt.get(a) if isinstance(a, ObjectRef) else a
                for a in args]
        kwargs = {k: (rt.get(v) if isinstance(v, ObjectRef) else v)
                  for k, v in kwargs.items()}
        rc = RequestContext(
            route=meta.get("route", ""),
            app_name=meta.get("app_name", self.app_name),
            multiplexed_model_id=meta.get("multiplexed_model_id", ""))
        token = set_request_context(rc)
        try:
            if self._is_function:
                fn = self._callable
            else:
                method_name = meta.get("call_method") or "__call__"
                fn = getattr(self._callable, method_name, None)
                if fn is None:
                    raise AttributeError(
                        f"deployment {self.deployment_name} has no method "
                        f"'{method_name}'")
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                # async callables (incl. the ASGI ingress adapter and
                # async function deployments) resolve on the actor's
                # persistent loop, with the request context re-applied
                # inside the loop thread
                result = _run_coro(result, rc)
            return result
        finally:
            from .context import _request_context
            _request_context.reset(token)

    def _track(self, t0: float, outcome: str,
               ttft_s: Optional[float] = None,
               cache_label: Optional[str] = None) -> None:
        """Record one finished request into the Prometheus pipeline.
        Runs in the request paths' finally blocks, so it must never
        raise: a telemetry failure would discard a computed response or
        shadow the request's real exception."""
        try:
            if outcome == "error":
                with self._lock:
                    self._num_errors += 1
            m = _replica_metrics()
            latency_ms = (time.perf_counter() - t0) * 1e3
            m["latency"].observe(latency_ms, tags=self._tags)
            self._recent_latency.add(latency_ms)
            if ttft_s is not None:
                m["ttft"].observe(ttft_s * 1e3,
                                  tags=dict(self._tags,
                                            cache=cache_label or ""))
                self._recent_ttft.add(ttft_s * 1e3)
            m["requests"].inc(1, tags=dict(self._tags, outcome=outcome))
            m["inflight"].set(self._inflight,
                              tags=dict(self._tags,
                                        replica=self.replica_tag))
        except Exception:  # noqa: BLE001 — telemetry must not fail a
            pass           # request or mask its real error

    def _reject_if_draining(self) -> None:
        """A request dispatched after this replica began its grace
        drain raced teardown: reject it with an ATTRIBUTED cause (the
        serving fault-tolerance invariant — never silently race the
        actor's death) so the handle retries on a live replica."""
        from .handle import RequestShedError

        with self._lock:
            draining = self._draining
        if draining:
            raise RequestShedError(
                f"replica {self.replica_tag} is draining for shutdown",
                retry_after_s=0.1, cause="draining")

    def handle_request(self, meta: Dict[str, Any], args: List[Any],
                       kwargs: Dict[str, Any]) -> Any:
        t0 = time.perf_counter()
        outcome = "ok"
        self._reject_if_draining()
        with self._lock:
            self._inflight += 1
            self._num_requests += 1
        try:
            return self._invoke(meta, args, kwargs)
        except BaseException:
            outcome = "error"
            raise
        finally:
            with self._lock:
                self._inflight -= 1
            self._track(t0, outcome)

    # every _ACK_EVERY-th chunk is a synchronous call instead of a notify:
    # bounds unacked in-flight data and detects a vanished consumer
    _ACK_EVERY = 64

    def handle_request_streaming(self, meta: Dict[str, Any], args: List[Any],
                                 kwargs: Dict[str, Any], stream_id: str,
                                 caller_addr) -> Any:
        """Streaming request path (reference replica.py:470
        handle_request_streaming). A generator/iterator result is pushed
        chunk-by-chunk straight to the caller's worker RPC server via
        stream_chunk frames and the final reply is ("gen", n_chunks); a
        plain result skips the stream entirely and comes back as
        ("value", result) — so the proxy can route EVERY request through
        here, like the reference's everything-streams HTTP proxy.

        In-flight accounting covers the whole generation, keeping pow-2
        routing and autoscaling honest for long streams."""
        from .._private import serialization
        from .._private.worker import global_worker

        t0 = time.perf_counter()
        outcome, ttft, cache_label = "ok", None, None
        self._reject_if_draining()
        with self._lock:
            self._inflight += 1
            self._num_requests += 1
        try:
            result = self._invoke(meta, args, kwargs)
            it = _as_iterator(result)
            if it is None:
                return ("value", result)
            client = global_worker.clients.get(tuple(caller_addr))
            seq = 0
            try:
                for item in it:
                    payload = serialization.dumps(item)
                    if ttft is None:  # first token/chunk produced
                        ttft = time.perf_counter() - t0
                        # batching-engine streams label their TTFT with
                        # the admission's prefix-cache outcome
                        # (engine.TokenStream.cache_outcome)
                        cache_label = getattr(it, "cache_outcome", None)
                    if (seq + 1) % self._ACK_EVERY == 0:
                        if not client.call("stream_chunk", stream_id, seq,
                                           payload, timeout=60.0):
                            break  # consumer closed the stream
                    else:
                        client.notify("stream_chunk", stream_id, seq, payload)
                    seq += 1
            finally:
                closer = getattr(it, "close", None)
                if callable(closer):
                    closer()
            return ("gen", seq)
        except BaseException:
            outcome = "error"
            raise
        finally:
            with self._lock:
                self._inflight -= 1
            self._track(t0, outcome, ttft_s=ttft, cache_label=cache_label)

    # -- control plane ------------------------------------------------------
    def get_queue_len(self) -> int:
        return self._inflight

    def get_metrics(self) -> Dict[str, Any]:
        with self._lock:
            out = {"replica_tag": self.replica_tag,
                   "inflight": self._inflight,
                   "num_requests": self._num_requests,
                   "num_errors": self._num_errors,
                   "uptime_s": time.time() - self._start_time}
        # recent trailing-window summaries beside the lifetime counters
        # (piggybacked to the controller on the health cadence; shown
        # by `serve status` and read by the autoscaling signal path)
        out["recent"] = {"latency_ms": self._recent_latency.summary(),
                         "ttft_ms": self._recent_ttft.summary()}
        return out

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if callable(fn):
            fn()
        return True

    def reconfigure(self, user_config: Any) -> None:
        fn = getattr(self._callable, "reconfigure", None)
        if callable(fn):
            fn(user_config)

    async def prepare_for_shutdown(self, timeout_s: float = 5.0) -> bool:
        """Drain in-flight requests — reference replica.py
        perform_graceful_shutdown. Async so the drain wait runs on the
        actor's event loop via `await asyncio.sleep` (shardlint
        blocking-in-async: a time.sleep poll here pinned one of the
        replica's request threads for the whole drain window)."""
        import asyncio

        with self._lock:
            # new arrivals now shed with cause "draining" instead of
            # racing the actor's death (the handle retries elsewhere)
            self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            await asyncio.sleep(0.05)
        # Optional user shutdown hook; __del__ is left to GC so
        # non-idempotent destructors don't run twice.
        fn = getattr(self._callable, "shutdown", None)
        if callable(fn):
            try:
                fn()
            except Exception:  # noqa: BLE001 — shutdown best-effort
                pass
        return True
