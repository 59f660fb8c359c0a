"""DeploymentHandle and its router (the port of ray_tpu/serve/handle.py)
— the reference's python/ray/serve/handle.py (DeploymentHandle :711,
DeploymentResponse) and _private/router.py:297 +
replica_scheduler/pow_2_scheduler.py:49.

Replica choice is power-of-two-choices over cached queue lengths: the
router keeps a per-replica in-flight estimate (incremented on submit,
decremented on completion) and periodically reconciles against
replica-reported queue lengths, like the reference's cached
RunningReplica queue-length probes.

`RequestShedError` is what a router raises instead of queueing past its
bound, with the client's backoff hint and the shed's cause.
`shed_counter()` counts every shed of this process by (app,
deployment): ``ray_tpu_serve_shed_total`` on `util.metrics`, created on
first use, shared with the disaggregated router.

Where the port differs: JAX's ``RAY_TPU_SERVE_MAX_QUEUE_DEPTH`` and
``RAY_TPU_SERVE_RETRY_AFTER_S`` overrides are not ported. The shed
bound is the deployment's ``max_ongoing_requests +
max_queued_requests``, and the backoff hint is ``RETRY_AFTER_S``.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


CONTROLLER_NAME = "SERVE_CONTROLLER"
# the JAX package's RAY_TPU_SERVE_RETRY_AFTER_S default
RETRY_AFTER_S = 1.0


class RequestShedError(RuntimeError):
    """Admission control's rejection: shed BEFORE the engine wedges.
    ``retry_after_s`` is the client's backoff hint; ``cause`` attributes
    the shed: ``capacity`` (the admission bound), ``deadline`` (the
    request outlived its deadline_s), ``failover`` (replica deaths used up
    the bounded retry budget), ``draining``, ``disconnect``."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 cause: str = "capacity"):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.cause = str(cause)

    def __reduce__(self):
        return (type(self), (str(self), self.retry_after_s, self.cause))


_shed_counter: Optional[Any] = None
_shed_lock = threading.Lock()


def shed_counter() -> Any:
    """This process's ``ray_tpu_serve_shed_total`` counter (JAX's name,
    help and tags), shared by every router so it covers every shed
    path."""
    global _shed_counter
    with _shed_lock:
        if _shed_counter is None:
            from ..util.metrics import Counter

            _shed_counter = Counter(
                "ray_tpu_serve_shed_total",
                "requests rejected by admission control (queue depth "
                "past the knob)",
                tag_keys=("app", "deployment"))
        return _shed_counter


class RequestMetadata:
    def __init__(self, call_method: str = "__call__",
                 multiplexed_model_id: str = "", is_http: bool = False,
                 app_name: str = "", route: str = ""):
        self.call_method = call_method
        self.multiplexed_model_id = multiplexed_model_id
        self.is_http = is_http
        self.app_name = app_name
        self.route = route

    def to_dict(self) -> Dict[str, Any]:
        return dict(call_method=self.call_method,
                    multiplexed_model_id=self.multiplexed_model_id,
                    is_http=self.is_http, app_name=self.app_name,
                    route=self.route)


class DeploymentResponse:
    """Future-like result of handle.remote() — reference handle.py
    DeploymentResponse. Pass it to another handle call and it resolves to the
    underlying ObjectRef (model composition without driver round-trips)."""

    def __init__(self, object_ref, router: "Router", replica_tag: str,
                 request: Optional[tuple] = None):
        self._object_ref = object_ref
        self._router = router
        self._replica_tag = replica_tag
        self._done = False
        # (meta, args, kwargs) for the dead-replica retry in result()
        self._request = request

    def result(self, timeout_s: Optional[float] = None) -> Any:
        import ray_tpu_torch as rt
        from ..exceptions import ActorDiedError, TaskError

        try:
            return rt.get(self._object_ref, timeout=timeout_s)
        except ActorDiedError:
            # The replica died with this request in flight — the exact
            # redeploy/drain window. A request that died with its replica
            # never completed, so re-assigning it to a live replica is
            # safe (reference router behavior: dead-replica requests are
            # retried against the refreshed replica set).
            self._mark_done()
            if self._request is None:
                raise
            meta, args, kwargs = self._request
            self._router._refresh(force=True)
            retried = self._router.assign(meta, args, kwargs)
            retried._request = None  # one retry: a second death raises
            return retried.result(timeout_s)
        except TaskError as e:
            # A replica that began its grace drain rejects the request
            # before running it (replica.py _reject_if_draining) — the
            # same raced-teardown window as a death, so retry the same
            # way; exhausted retries surface the ATTRIBUTED shed, not
            # the opaque TaskError wrapper.
            shed = e.cause if isinstance(e.cause, RequestShedError) \
                else None
            if shed is None or shed.cause != "draining":
                raise
            self._mark_done()
            if self._request is None:
                raise shed from e
            meta, args, kwargs = self._request
            self._router._refresh(force=True)
            retried = self._router.assign(meta, args, kwargs)
            retried._request = None
            return retried.result(timeout_s)
        finally:
            self._mark_done()

    async def result_async(self, timeout_s: Optional[float] = None) -> Any:
        """Loop-safe result(): the blocking get — and the dead-replica
        retry inside it, whose re-pick may wait for a replacement
        replica — runs on the default executor, so an async deployment
        method can `await resp.result_async()` (or just `await resp`)
        without stalling its event loop."""
        import asyncio
        import functools

        return await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(self.result, timeout_s))

    def __await__(self):
        # `resp = await handle.remote_async(x); y = await resp`
        return self.result_async().__await__()

    def _to_object_ref(self):
        self._mark_done()
        return self._object_ref

    def _mark_done(self):
        if not self._done:
            self._done = True
            self._router._complete(self._replica_tag)

    def __del__(self):
        # Fire-and-forget callers drop the response without result();
        # release the router's in-flight slot so pow-2 routing and the
        # autoscaler metrics don't leak upward forever.
        try:
            self._mark_done()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class StreamingDeploymentResponse:
    """Iterator over chunks a replica streams back (reference
    handle.py DeploymentResponseGenerator / replica handle_request_
    streaming). Chunks arrive as stream_chunk pushes into a local worker
    stream endpoint; iteration ends when the replica's final reply lands
    and every pushed chunk is consumed. If the user method returned a
    plain value instead of a generator, iteration yields nothing and
    `.value` holds the result (`.kind` tells which case occurred).

    Not picklable — consume it in the process that made the call."""

    _POLL_S = 0.05

    def __init__(self, object_ref, router: "Router", replica_tag: str,
                 stream_id: str, chunk_queue,
                 chunk_timeout_s: float = 120.0):
        self._ref = object_ref
        self._router = router
        self._replica_tag = replica_tag
        self._stream_id = stream_id
        self._queue = chunk_queue
        self._chunk_timeout_s = chunk_timeout_s
        self._consumed = 0
        self._total: Optional[int] = None  # known once the reply lands
        self._buffer: Dict[int, bytes] = {}
        self._finished = False
        self.kind: Optional[str] = None    # "gen" | "value"
        self.value: Any = None

    def __iter__(self) -> "StreamingDeploymentResponse":
        return self

    def __next__(self) -> Any:
        import queue as _queue

        from .._private import serialization

        deadline = time.monotonic() + self._chunk_timeout_s
        while True:
            if self._consumed in self._buffer:
                payload = self._buffer.pop(self._consumed)
                self._consumed += 1
                return serialization.loads(payload)
            try:
                seq, payload = self._queue.get(timeout=self._POLL_S)
                self._buffer[seq] = payload
                continue
            except _queue.Empty:
                pass
            try:
                self._check_final()
            except BaseException:
                self._finish()
                raise
            if self.kind == "value" or (
                    self._total is not None
                    and self._consumed >= self._total):
                self._finish()
                raise StopIteration
            if time.monotonic() > deadline:
                self._finish()
                raise TimeoutError(
                    f"no stream chunk within {self._chunk_timeout_s}s")

    def _check_final(self) -> None:
        """Adopt the replica's final reply once it is ready (non-blocking);
        raises the replica's error if the stream failed mid-generation."""
        if self.kind is not None:
            return
        import ray_tpu_torch as rt

        ready, _ = rt.wait([self._ref], timeout=0)
        if not ready:
            return
        kind, payload = rt.get(self._ref)
        if kind == "value":
            self.kind, self.value = "value", payload
        else:
            self.kind, self._total = "gen", int(payload)

    def first_event(self):
        """('chunk', item) | ('value', v) | ('end', None) — lets the HTTP
        proxy decide between a plain and a chunked response."""
        try:
            return ("chunk", next(self))
        except StopIteration:
            if self.kind == "value":
                return ("value", self.value)
            return ("end", None)

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        from .._private.worker import global_worker

        if global_worker is not None:
            global_worker.close_stream(self._stream_id)
        self._router._complete(self._replica_tag)

    def __del__(self):
        try:
            self._finish()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class Router:
    """Caches the replica set for one deployment (refreshed from the
    controller on a version bump) and schedules requests pow-2 style."""

    _REFRESH_S = 1.0

    _METRICS_PUSH_S = 0.5

    def __init__(self, deployment_name: str, app_name: str):
        self._deployment = deployment_name
        self._app = app_name
        self._lock = threading.Lock()
        self._version = -1
        self._replicas: List[Tuple[str, Any]] = []  # (tag, ActorHandle)
        self._inflight: Dict[str, int] = {}
        self._last_refresh = 0.0
        self._handle_id = f"router-{id(self):x}"
        self._metrics_started = False
        self._stopped = False
        # admission control: per-replica in-flight is bounded at
        # max_ongoing + max_queued_requests (deployment config, fetched
        # with the replica set)
        self._limits: Dict[str, Any] = {}
        self._limits_pending = False

    def _controller(self):
        import ray_tpu_torch as rt
        return rt.get_actor(CONTROLLER_NAME)

    _router_gauge = None
    _router_gauge_lock = threading.Lock()

    @classmethod
    def _queue_depth_gauge(cls):
        """Process-wide router queue-depth gauge (queued+ongoing per
        handle, the same number the controller autoscales on), exported
        through the util.metrics Prometheus pipeline. Double-checked:
        unlocked fast path per push tick; the lock only guards the
        first registration so racing push loops of two handles cannot
        register duplicates."""
        if cls._router_gauge is not None:
            return cls._router_gauge
        with cls._router_gauge_lock:
            if cls._router_gauge is None:
                from ..util.metrics import Gauge

                cls._router_gauge = Gauge(
                    "serve_router_queue_depth",
                    "requests queued+ongoing through this handle",
                    tag_keys=("app", "deployment", "handle"))
        return cls._router_gauge

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        with self._lock:
            stale = force or not self._replicas or \
                now - self._last_refresh > self._REFRESH_S
        if not stale:
            return
        import ray_tpu_torch as rt
        ctrl = self._controller()
        version, replicas = rt.get(
            ctrl.get_replicas.remote(self._app, self._deployment))
        limits = None
        with self._lock:
            need_limits = version != self._version or \
                self._limits_pending
        if need_limits:
            try:
                limits = rt.get(ctrl.get_deployment_limits.remote(
                    self._app, self._deployment))
            except Exception:  # noqa: BLE001 — pre-admission controller
                limits = None
        with self._lock:
            self._last_refresh = time.monotonic()
            if version != self._version:
                self._version = version
                self._replicas = list(replicas)
                self._inflight = {tag: self._inflight.get(tag, 0)
                                  for tag, _ in self._replicas}
            if need_limits:
                if limits is not None:
                    self._limits = dict(limits)
                    self._limits_pending = False
                else:
                    # transient controller failure must not disable
                    # admission control until the next redeploy —
                    # retry the fetch on the next refresh
                    self._limits_pending = True

    _PICK_TIMEOUT_S = 30.0

    def _shed_bound(self) -> Optional[int]:
        """Per-replica in-flight bound for admission control
        (max_ongoing + max_queued_requests), or None when shedding is
        disabled (max_queued_requests < 0) or the limits fetch has not
        landed: guessing the replica's capacity would shed healthy
        capacity on any deployment sized above the default."""
        lim = self._limits or {}
        queued = lim.get("max_queued_requests", -1)
        if queued is None or int(queued) < 0 or \
                "max_ongoing_requests" not in lim:
            return None
        return int(lim["max_ongoing_requests"]) + int(queued)

    def _raise_shed(self, bound: int) -> None:
        retry = RETRY_AFTER_S
        shed_counter().inc(tags={"app": self._app,
                                 "deployment": self._deployment})
        raise RequestShedError(
            f"deployment {self._app}#{self._deployment}: every replica "
            f"is at its in-flight bound ({bound}); retry after "
            f"{retry:.1f}s", retry_after_s=retry)

    _SHED = object()  # _try_pick sentinel: every replica at its bound

    def _try_pick(self, bound: Optional[int] = None):
        """One non-blocking pow-2 choice; None when no replicas are
        known. The admission bound is enforced UNDER the same lock as
        the in-flight reservation (check-then-act would let N racing
        callers all pass a separate shed check before any increments,
        making max_queued_requests advisory): candidates are the
        replicas still under `bound`, and when there are none the
        `_SHED` sentinel is returned for the caller to raise on outside
        the lock. On success the replica's in-flight count is already
        incremented. An empty replica set defers to the pick wait (a
        deploying app is not overload)."""
        with self._lock:
            if not self._replicas:
                return None
            cands = self._replicas
            if bound is not None:
                cands = [r for r in self._replicas
                         if self._inflight.get(r[0], 0) < bound]
                if not cands:
                    return self._SHED
            if len(cands) == 1:
                chosen = cands[0]
            else:
                a, b = random.sample(cands, 2)
                chosen = a if self._inflight.get(a[0], 0) <= \
                    self._inflight.get(b[0], 0) else b
            self._inflight[chosen[0]] = \
                self._inflight.get(chosen[0], 0) + 1
            return chosen

    def _no_replica_error(self) -> TimeoutError:
        return TimeoutError(
            f"no running replicas for deployment "
            f"{self._app}#{self._deployment} after "
            f"{self._PICK_TIMEOUT_S:.0f}s")

    def _pick(self, bound: Optional[int] = None) -> Tuple[str, Any]:
        deadline = time.monotonic() + self._PICK_TIMEOUT_S
        while True:
            self._refresh()
            chosen = self._try_pick(bound)
            if chosen is self._SHED:
                self._raise_shed(bound)
            if chosen is not None:
                return chosen
            if time.monotonic() > deadline:
                raise self._no_replica_error()
            # The wait below blocks this thread. On an event-loop thread
            # that would freeze EVERY coroutine on the loop for up to 30s
            # (shardlint blocking-in-async) — fail fast with the async
            # alternative instead of silently wedging the replica.
            try:
                import asyncio

                asyncio.get_running_loop()
            except RuntimeError:
                pass
            else:
                raise RuntimeError(
                    f"no replica of {self._app}#{self._deployment} is "
                    "available and the blocking wait would stall this "
                    "thread's running event loop; use `await "
                    "handle.remote_async(...)` from async code, or "
                    "offload the call with loop.run_in_executor")
            time.sleep(0.1)

    async def _pick_async(self, bound: Optional[int] = None
                          ) -> Tuple[str, Any]:
        """Async pick: the controller refresh (a blocking RPC) runs on
        the default executor and the no-replica wait is an
        `await asyncio.sleep`, so the caller's event loop keeps serving
        other requests while this one waits for a replica."""
        import asyncio

        loop = asyncio.get_running_loop()
        deadline = time.monotonic() + self._PICK_TIMEOUT_S
        while True:
            await loop.run_in_executor(None, self._refresh)
            chosen = self._try_pick(bound)
            if chosen is self._SHED:
                self._raise_shed(bound)
            if chosen is not None:
                return chosen
            if time.monotonic() > deadline:
                raise self._no_replica_error()
            await asyncio.sleep(0.1)

    def _complete(self, tag: str):
        with self._lock:
            if tag in self._inflight and self._inflight[tag] > 0:
                self._inflight[tag] -= 1

    def _start_metrics_push(self):
        """Handle-side autoscaling metrics — reference serve/_private/
        router.py pushes num_queued+ongoing per handle to the controller
        (autoscaling_state.py); replica-side probes would deadlock behind a
        saturated replica's own request pool."""
        with self._lock:
            if self._metrics_started:
                return
            self._metrics_started = True

        def push_loop():
            while not self._stopped:
                time.sleep(self._METRICS_PUSH_S)
                try:
                    with self._lock:
                        total = sum(self._inflight.values())
                    self._queue_depth_gauge().set(
                        total, tags={"app": self._app,
                                     "deployment": self._deployment,
                                     "handle": self._handle_id})
                    self._controller().record_handle_metrics.remote(
                        self._app, self._deployment, self._handle_id, total)
                except Exception:  # noqa: BLE001 — controller restarting
                    pass

        threading.Thread(target=push_loop, daemon=True,
                         name="serve-handle-metrics").start()

    def assign(self, meta: RequestMetadata, args, kwargs,
               retries: int = 2) -> DeploymentResponse:
        self._start_metrics_push()
        self._refresh()
        bound = self._shed_bound()
        last_err: Optional[Exception] = None
        for _ in range(retries + 1):
            tag, handle = self._pick(bound)
            try:
                ref = handle.handle_request.remote(
                    meta.to_dict(), list(args), dict(kwargs))
                return DeploymentResponse(ref, self, tag,
                                          request=(meta, args, kwargs))
            except Exception as e:  # noqa: BLE001 — dead replica: drop + retry
                last_err = e
                self._complete(tag)
                self._refresh(force=True)
        raise last_err  # type: ignore[misc]

    async def assign_async(self, meta: RequestMetadata, args, kwargs,
                           retries: int = 2) -> DeploymentResponse:
        """Async twin of assign() for callers already on an event loop
        (async deployment methods composing other deployments): picking
        waits with `await asyncio.sleep` and the submit RPC runs on the
        default executor, so the loop never blocks."""
        import asyncio

        loop = asyncio.get_running_loop()
        self._start_metrics_push()
        await loop.run_in_executor(None, self._refresh)
        bound = self._shed_bound()
        last_err: Optional[Exception] = None
        for _ in range(retries + 1):
            tag, handle = await self._pick_async(bound)
            try:
                ref = await loop.run_in_executor(
                    None, lambda: handle.handle_request.remote(
                        meta.to_dict(), list(args), dict(kwargs)))
                return DeploymentResponse(ref, self, tag,
                                          request=(meta, args, kwargs))
            except Exception as e:  # noqa: BLE001 — dead replica: retry
                last_err = e
                self._complete(tag)
                await loop.run_in_executor(
                    None, lambda: self._refresh(force=True))
        raise last_err  # type: ignore[misc]

    def assign_stream(self, meta: RequestMetadata, args, kwargs,
                      retries: int = 2) -> StreamingDeploymentResponse:
        """Streaming variant of assign: opens a local stream endpoint the
        replica pushes chunks at (reference router streaming path)."""
        from .._private.worker import global_worker

        self._start_metrics_push()
        self._refresh()
        bound = self._shed_bound()
        last_err: Optional[Exception] = None
        for _ in range(retries + 1):
            tag, handle = self._pick(bound)
            stream_id, q = global_worker.open_stream()
            try:
                ref = handle.handle_request_streaming.remote(
                    meta.to_dict(), list(args), dict(kwargs), stream_id,
                    tuple(global_worker.address))
                return StreamingDeploymentResponse(ref, self, tag,
                                                   stream_id, q)
            except Exception as e:  # noqa: BLE001 — dead replica: retry
                global_worker.close_stream(stream_id)
                last_err = e
                self._complete(tag)
                self._refresh(force=True)
        raise last_err  # type: ignore[misc]


# One Router per (app, deployment) per process — shared across all handles
# (including the throwaway ones __getattr__/options() mint), so pow-2
# in-flight state is coherent and only one metrics thread exists per target.
_ROUTERS: Dict[Tuple[str, str], Router] = {}
_ROUTERS_LOCK = threading.Lock()


def _shared_router(deployment_name: str, app_name: str) -> Router:
    key = (app_name, deployment_name)
    with _ROUTERS_LOCK:
        r = _ROUTERS.get(key)
        if r is None:
            r = Router(deployment_name, app_name)
            _ROUTERS[key] = r
        return r


def _drop_routers(app_name: Optional[str] = None) -> None:
    """Forget cached routers (on serve.shutdown/delete) so a later
    redeploy doesn't serve stale replica sets."""
    with _ROUTERS_LOCK:
        for key in [k for k in _ROUTERS
                    if app_name is None or k[0] == app_name]:
            _ROUTERS[key]._stopped = True  # ends its metrics thread
            del _ROUTERS[key]


class DeploymentHandle:
    """Picklable handle to a deployment — reference serve/handle.py:711.
    ``handle.method.remote(*args)`` returns a DeploymentResponse."""

    def __init__(self, deployment_name: str, app_name: str = "default",
                 _call_method: str = "__call__",
                 _multiplexed_model_id: str = "", _stream: bool = False):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._call_method = _call_method
        self._multiplexed_model_id = _multiplexed_model_id
        self._stream = _stream

    @property
    def _router(self) -> Router:
        return _shared_router(self.deployment_name, self.app_name)

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            _call_method=method_name or self._call_method,
            _multiplexed_model_id=(multiplexed_model_id
                                   if multiplexed_model_id is not None
                                   else self._multiplexed_model_id),
            _stream=self._stream if stream is None else stream)

    def _request(self, args, kwargs):
        meta = RequestMetadata(
            call_method=self._call_method,
            multiplexed_model_id=self._multiplexed_model_id,
            app_name=self.app_name)
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse)
                     else a for a in args)
        kwargs = {k: (v._to_object_ref() if isinstance(v, DeploymentResponse)
                      else v) for k, v in kwargs.items()}
        return meta, args, kwargs

    def remote(self, *args, **kwargs):
        meta, args, kwargs = self._request(args, kwargs)
        if self._stream:
            return self._router.assign_stream(meta, args, kwargs)
        return self._router.assign(meta, args, kwargs)

    async def remote_async(self, *args, **kwargs) -> DeploymentResponse:
        """Loop-safe `remote()` for async deployment methods: awaiting it
        never blocks the event loop, even while waiting for a replica to
        come up (the sync path refuses to poll-wait on a loop thread)."""
        meta, args, kwargs = self._request(args, kwargs)
        if self._stream:
            raise NotImplementedError(
                "remote_async does not support stream=True handles yet; "
                "use options(stream=True).remote() from a worker thread")
        return await self._router.assign_async(meta, args, kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self._call_method,
                 self._multiplexed_model_id, self._stream))

    def __repr__(self):
        return (f"DeploymentHandle(deployment='{self.deployment_name}', "
                f"app='{self.app_name}')")
