"""Per-process runtime: driver connect, task submission, task execution.

This is the analog of the reference's core worker
(src/ray/core_worker/core_worker.cc — SubmitTask :2067,
CreateActor :2139, SubmitActorTask :2377, Put :1198, Get :1460) plus the
Python driver layer (python/ray/_private/worker.py — init :1214, get :2523,
put :2655, wait :2720). One `Worker` instance per process (`global_worker`),
in one of two modes:

- "driver": created by `ray_tpu_torch.init()`; may also host the
  in-process Conductor when starting a new local cluster.
- "worker": created by worker_main in processes the conductor spawns; runs an
  RPC server accepting pushed tasks (reference: direct worker-to-worker task
  push, core_worker.proto PushTask) and actor instantiation.

Submission protocol (reference direct_task_transport.h:75 kept):
  submitter resolves ObjectRef deps → leases a worker from the conductor →
  pushes the task directly to the worker → stores inline results / locators →
  returns the lease. Lineage for retries is kept submitter-side
  (reference task_manager.h:208); lost large objects are reconstructed by
  re-executing the producing task (object_recovery_manager.cc semantics).

Calls that end a process (`shutdown_worker`, a force cancel, an actor's
`exit_actor()`) raise in a driver instead: a stray RPC must not end the
user's program. A driver mirrors the workers' output lines from the
`worker_logs` channel to its stderr (the `log_to_driver` flag).

A task's or actor's `runtime_env` is prepared (staged through the
conductor's KV) at submission and applied around a task (restored
after) or around an actor's whole life (before its class's `__init__`,
so before its first CUDA call). With tracing on in the submitter
(`util.tracing.enable()`), the wire carries a W3C traceparent and the
executor records a `task:<name>` or `actor:<Class>.<method>` span under
it; spans ride the task-event flush to the conductor. A worker answers
`start_device_profile` / `stop_device_profile` with a torch.profiler
trace of its process (`util.profiling`). A job's driver gives its
job's runtime_env (RTT_JOB_RUNTIME_ENV) to every task and actor it
submits, under their own. The compiled-DAG hook is not ported; a call
that needs it raises NotImplementedError naming the ROADMAP item.
"""
from __future__ import annotations

import asyncio
import contextlib
import os
import queue
import threading
import time
import traceback
import uuid
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from .. import exceptions as exc
from . import serialization
from .ids import JobID, ObjectID, TaskID
from .object_store import LocalObjectStore, ObjectRef, shm_threshold
from .rpc import (ClientPool, ConnectionLost, ReconnectingClient,
                  RemoteError, RpcServer)

global_worker: Optional["Worker"] = None

DEFAULT_MAX_RETRIES = 3

# Where this worker process's start went, on the boot clock (one clock
# for every process of the machine): `worker_main` entered, a GPU
# worker's torch imported, registered, `become_actor` reached, the
# actor's spec unpickled. A caller splits an actor's cold start from
# them (chip_smoke.py's `serve_deploy`).
STARTUP: Dict[str, float] = {}


def stamp_startup(name: str) -> None:
    STARTUP.setdefault(name, time.clock_gettime(time.CLOCK_BOOTTIME))


def loaded(module: str):
    """A module of the package ("util.tracing") if this process imported
    it, else None: hooks of optional parts import nothing."""
    import sys

    return sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.{module}")


def _current_traceparent() -> Optional[str]:
    """The calling thread's traceparent, or None while tracing is off
    (the common case: util.tracing was never imported)."""
    tracing = loaded("util.tracing")
    return tracing.current_traceparent() if tracing is not None else None


def _lease_idle_ttl() -> float:
    from .config import config

    return config.lease_idle_ttl


def _fetch_chunk() -> int:
    """Chunk size for cross-host pulls (reference pull_manager.cc: 64MB).
    Read through the flag table at use time so _system_config overrides
    reach this process too, not only spawned children."""
    from .config import config

    return config.fetch_chunk


def _compute_machine_id(forced: bool) -> str:
    """Identity of this HOST (not process): shm handoff is only valid
    between processes that share it. `forced` (the force_remote_fetch
    flag) makes every process claim a distinct machine (tests exercise
    the cross-host chunked path on one box)."""
    if forced:
        return f"forced-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    import socket as _socket

    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f"{_socket.gethostname()}/{f.read().strip()}"
    except OSError:
        return _socket.gethostname()


_machine_ids: Dict[bool, str] = {}


def machine_id() -> str:
    """This process's machine id under the flag table in force (read
    at use time: a worker's table arrives after import)."""
    from .config import config

    forced = bool(config.force_remote_fetch)
    mid = _machine_ids.get(forced)
    if mid is None:
        mid = _machine_ids[forced] = _compute_machine_id(forced)
    return mid


def _refuse_in_driver(worker: "Worker", what: str) -> None:
    """Calls that end the process run only in workers."""
    if worker.mode == "driver":
        raise RuntimeError(f"{what} would end this driver process; it "
                           "runs only in workers")


@dataclass
class TaskSpec:
    task_id: str
    name: str
    fn_bytes: bytes  # cloudpickled callable
    args: tuple
    kwargs: dict
    return_ids: List[str]
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = DEFAULT_MAX_RETRIES
    owner: Optional[Tuple[str, int]] = None
    # DEFAULT = pack (head-first); SPREAD = emptiest node first
    # (reference scheduling_strategy on @ray.remote)
    scheduling_strategy: Any = "DEFAULT"
    placement_group_id: Optional[str] = None
    runtime_env: Optional[Dict[str, Any]] = None  # prepared (kv:// URIs)
    # W3C traceparent captured on the SUBMITTING thread (spans are
    # thread-local; the submit thread that pushes has none)
    traceparent: Optional[str] = None


def _top_level_refs(args: tuple, kwargs: dict) -> List[ObjectRef]:
    """Top-level ObjectRef deps only, matching the reference's dependency
    resolver (dependency_resolver.cc)."""
    deps = [a for a in args if isinstance(a, ObjectRef)]
    deps += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
    return deps


class _Job:
    """A normal task on its way to a worker: its spec, the lease key it
    queues under, its crash retries left and the watchdog future that is
    set once its results (or its error) are recorded."""

    __slots__ = ("spec", "key", "deps", "retries", "future")

    def __init__(self, spec: TaskSpec, key: tuple):
        self.spec = spec
        self.key = key
        self.deps = _top_level_refs(spec.args, spec.kwargs)
        self.retries = spec.max_retries
        self.future: Future = Future()


class Worker:
    def __init__(self, mode: str, conductor_address: Tuple[str, int],
                 session_dir: str, worker_id: Optional[str] = None):
        self.mode = mode
        self.worker_id = worker_id or uuid.uuid4().hex
        self.job_id = JobID().hex()
        self.session_dir = session_dir
        self.store = LocalObjectStore(
            spill_dir=os.path.join(session_dir, "spill", self.worker_id[:12]))
        self.clients = ClientPool()
        # reconnecting: survives a conductor restart (persistence story)
        self.conductor = ReconnectingClient(conductor_address,
                                            connect_retries=30)
        self.conductor_address = tuple(conductor_address)
        self.handler = WorkerHandler(self)
        self.server = RpcServer(self.handler, max_workers=32).start()
        self.address = self.server.address
        # Normal tasks hold no thread while they run (reference
        # normal_task_submitter.cc: a queue per scheduling key, pushes
        # pipelined onto granted leases). A task whose arguments exist
        # queues under its lease key at once; its push is sent without
        # waiting, and the reply is settled on the small completion pool,
        # which hands the lease straight to the key's next task. Before,
        # each task parked one of 16 submit threads for its whole push
        # and the threads convoyed on the GIL (pipelined 884 tasks/s
        # against 1977/s serial on 8 cores). Lease fetches are sent the
        # same way. What still blocks has a pool of its own, so one kind
        # of wait never starves another: dependency waits (bounded, see
        # _wait_dep_ready) and actor calls (the submit pool).
        n_block = min(16, max(4, 4 * (os.cpu_count() or 1)))
        self._submit_pool = ThreadPoolExecutor(
            max_workers=n_block, thread_name_prefix="task-submit")
        self._dep_pool = ThreadPoolExecutor(
            max_workers=n_block, thread_name_prefix="task-deps")
        self._done_pool = ThreadPoolExecutor(
            max_workers=min(4, max(2, (os.cpu_count() or 1) // 2)),
            thread_name_prefix="task-done")
        self._ready: Dict[tuple, Deque[_Job]] = {}  # lease key -> queue
        # Worker-lease reuse cache (reference: normal_task_submitter.cc
        # keeps granted leases and pipelines same-shape tasks onto them).
        # Going back to the conductor for every task measured 235 tasks/s
        # pipelined — 8x UNDER the serial round-trip rate — because each
        # task paid lease+return RPCs plus four cross-thread wakeups;
        # reusing the lease for the next queued spec makes the hot path
        # one direct push per task. Entries: shape key -> [(worker_id,
        # address, idle_since)]; a reaper returns leases idle > TTL so
        # other drivers are never starved for long.
        self._lease_cache: Dict[tuple, List[Tuple[str, Tuple[str, int],
                                                  float]]] = {}
        self._lease_cache_lock = threading.Lock()
        # guards the lease cache, the ready queues and the fetch flags
        # (one lease fetch per key at a time, see _pump)
        self._lease_cv = threading.Condition(self._lease_cache_lock)
        self._lease_fetching: Dict[tuple, bool] = {}
        self._lease_reaper_started = False
        # owner-side state
        self._lineage: Dict[str, TaskSpec] = {}   # object_id -> producing spec
        self._pending_ids: set = set()            # ids awaiting a local result
        self._locators: Dict[str, Tuple[str, int]] = {}  # large-result holders
        # return_id -> submit-pool Future: the watchdog signal. A future
        # that is done while its ids are still pending means the submit
        # thread vanished without recording results — that must surface as
        # an error, never a silent forever-wait.
        self._inflight: Dict[str, Future] = {}
        # cancellation (reference CoreWorker::CancelTask core_worker.cc):
        # owner-side cancelled ids + where each pending id is executing
        self._cancelled: set = set()
        self._executing_at: Dict[str, Tuple[str, int]] = {}
        # push-based readiness (reference: ownership-based object directory
        # callbacks, object_directory.cc subscriptions — waiters subscribe
        # once and the owner pushes, instead of the waiter polling RPCs)
        self._object_waiters: Dict[str, set] = {}  # owner: oid -> waiters
        self._remote_ready: set = set()            # waiter: pushed-ready ids
        self._subscribed: set = set()              # ids subscribed at owner
        # conductor pubsub fan-in: channel -> local callbacks
        self._pub_lock = threading.Lock()
        self._pub_handlers: Dict[str, list] = {}
        self._pub_channels: set = set()
        # local endpoints remote producers push stream_chunk frames at
        # (reference: streaming generator refs, task_manager ObjectRefStream)
        self._streams: Dict[str, "queue.Queue"] = {}
        # executor-side: return_id -> thread ident running it (for the
        # cooperative async-exception interrupt)
        self._exec_threads: Dict[str, int] = {}
        # executor threads currently blocked in get()/wait() with their
        # lease parked at the conductor
        self._blocked_idents: set = set()
        self._state_lock = threading.Lock()
        # per-caller actor-call send ordering: frames must hit the socket in
        # seqno order or the server's reorder buffer can adopt a too-high
        # base and stall (reference: sequential_actor_submit_queue.cc)
        self._send_seq: Dict[str, int] = {}
        self._send_cv = threading.Condition()
        self._actor_runtime: Optional["ActorRuntime"] = None
        self._shutdown = False
        self._task_events: List[Dict[str, Any]] = []
        self._task_events_lock = threading.Lock()
        # a job's driver: the job's runtime_env, beneath every task's own
        self.job_runtime_env: Dict[str, Any] = {}
        if mode == "driver":
            from . import runtime_env as renv

            self.job_runtime_env = renv.job_runtime_env()
        threading.Thread(target=self._event_flush_loop, daemon=True,
                         name="task-event-flush").start()
        from . import refcount

        refcount.tracker.attach(self)
        if mode == "driver":
            self._maybe_mirror_worker_logs()

    def _maybe_mirror_worker_logs(self) -> None:
        """log_to_driver (reference log_monitor.py): print worker
        stdout/stderr lines arriving on the worker_logs channel to this
        driver's stderr."""
        from .config import config

        if not config.log_to_driver:
            return
        import sys

        from .log_monitor import format_log_line

        def on_lines(batch) -> None:
            try:
                for entry in batch:
                    sys.stderr.write(format_log_line(entry) + "\n")
                sys.stderr.flush()
            except Exception:  # noqa: BLE001 — closed stderr on teardown
                pass

        self.subscribe_channel("worker_logs", on_lines)

    # ------------------------------------------------------------ put / get

    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed")
        ref = ObjectRef(locator=self.address, owner=self.address)
        self.store.put_value(ref.id, value)
        return ref

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in ref_list:
            remaining = None if deadline is None else deadline - time.monotonic()
            out.append(self._get_one(r, remaining))
        return out[0] if single else out

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        self._make_local(ref, timeout)
        return self._load_local(ref)

    def get_records(self, refs: Sequence[ObjectRef],
                    timeout: Optional[float] = None
                    ) -> List[Tuple[bytes, List[bytes]]]:
        """Each object's stored record (meta, buffers), fetched here but
        not loaded; a stored error raises (a client proxy's `get`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in refs:
            self._make_local(r, None if deadline is None
                             else deadline - time.monotonic())
            meta, total, sizes = self.store.stream_info(r.id)
            data = self.store.read_range(r.id, 0, total)
            bufs, off = [], 0
            for n in sizes:
                bufs.append(data[off:off + n])
                off += n
            out.append((meta, bufs))
        return out

    def _make_local(self, ref: ObjectRef, timeout: Optional[float]) -> None:
        """Block until `ref`'s value (or error) is in this store."""
        if self.store.contains(ref.id):  # fast path: no lease dance
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        attempts = 0
        with self._lease_released_while_blocked():
            while True:
                if self.store.contains(ref.id):
                    return
                if self._is_pending_local(ref.id):
                    self._wait_result(ref.id, deadline)
                    continue
                try:
                    self._fetch(ref, deadline)
                    continue
                except (ConnectionLost, KeyError, FileNotFoundError,
                        exc.ObjectLostError) as e:
                    attempts += 1
                    if attempts > 1 + self._lineage_retries(ref.id) or \
                            not self._try_reconstruct(ref):
                        raise exc.ObjectLostError(
                            ref.id, f"fetch failed ({e}) and "
                            "reconstruction unavailable") from e

    @contextlib.contextmanager
    def _lease_released_while_blocked(self):
        """An EXECUTOR thread entering a blocking get()/wait() parks its
        lease at the conductor so the tasks it waits on can schedule
        (reference: raylet resource release for workers blocked in
        ray.get — without it, dependent tasks deadlock the moment they
        outnumber CPUs). No-op for drivers, non-executor threads, and
        nested blocking sections."""
        # actor workers hold no CPU lease (state ACTOR, resources ~0) —
        # the conductor would no-op, so skip the RPC pair entirely
        if self.mode != "worker" or self._actor_runtime is not None:
            yield
            return
        ident = threading.get_ident()
        with self._state_lock:
            hook = ident in self._exec_threads.values() \
                and ident not in self._blocked_idents
        if not hook:
            yield
            return
        try:
            # registration inside the try: an async-exc cancel landing
            # anywhere past this point unwinds through the finally, so
            # the ident can never leak (a leak would permanently disable
            # lease-parking for this pool thread)
            with self._state_lock:
                self._blocked_idents.add(ident)
            try:
                self.conductor.notify("worker_blocked", self.worker_id)
            except ConnectionLost:
                pass
            yield
        finally:
            while True:  # injection-proof teardown (cf. _pop_exec_threads)
                try:
                    with self._state_lock:
                        self._blocked_idents.discard(ident)
                    try:
                        self.conductor.notify("worker_unblocked",
                                              self.worker_id)
                    except ConnectionLost:
                        pass
                    break
                except exc.TaskCancelledError:
                    continue

    def _load_local(self, ref: ObjectRef) -> Any:
        value = self.store.get_local(ref.id)  # raises stored errors
        if isinstance(value, exc.RayTpuError):
            raise value
        return value

    def _is_pending_local(self, object_id: str) -> bool:
        with self._state_lock:
            return object_id in self._pending_ids

    def _wait_result(self, object_id: str, deadline: Optional[float]) -> None:
        """Block until the local store holds an entry for `object_id` OR the
        id is no longer pending (large results are recorded as remote
        locators, which never create a store entry — waiting on the store cv
        alone would hang forever; this was a real livelock when a result
        larger than the store cap came back spilled→locator). Raises
        GetTimeoutError at `deadline` while still unresolved."""
        while True:
            with self._state_lock:
                pending = object_id in self._pending_ids
                fut = self._inflight.get(object_id)
            if not pending:
                return  # resolved out-of-store (locator) — caller fetches
            if fut is not None and fut.done():
                # watchdog: submit thread gone, id still pending — surface
                # an error rather than wait forever
                err = None
                try:
                    err = fut.exception(timeout=0)
                except BaseException as e2:  # noqa: BLE001 — incl. Cancelled
                    err = e2
                self.store.put_error(object_id, exc.TaskError(
                    err or SystemError("submit thread exited without "
                                       "recording results"),
                    "", "submit-watchdog"))
                with self._state_lock:
                    self._pending_ids.discard(object_id)
                    self._cancelled.discard(object_id)
                    self._inflight.pop(object_id, None)
                self._notify_object_waiters([object_id])
                return
            rem = None if deadline is None else deadline - time.monotonic()
            if rem is not None and rem <= 0:
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {object_id[:12]}…")
            if self.store.wait_ready_once(
                    object_id, 0.2 if rem is None else min(0.2, rem)):
                return

    def _locator_of(self, object_id: str) -> Optional[Tuple[str, int]]:
        with self._state_lock:
            return self._locators.get(object_id)

    def _fetch(self, ref: ObjectRef, deadline: Optional[float]) -> None:
        """Pull a value from its holder; fall back to asking the owner."""
        addr = self._locator_of(ref.id) or ref.locator
        if addr is not None and tuple(addr) != self.address:
            try:
                reply = self.clients.get(tuple(addr)).call(
                    "fetch_object", ref.id, machine_id(), timeout=60.0)
                self._consume_fetch_reply(ref.id, reply, tuple(addr))
                return
            except (ConnectionLost, RemoteError) as e:
                if isinstance(e, RemoteError) and not isinstance(
                        e.cause, (KeyError, FileNotFoundError)):
                    raise
                # holder gone or evicted: ask the owner below
        owner = ref.owner
        if owner is None or tuple(owner) == self.address:
            raise exc.ObjectLostError(ref.id, "no live holder and no owner")
        rem = None if deadline is None else max(0.1, deadline - time.monotonic())
        kind, payload = self.clients.get(tuple(owner)).call(
            "resolve_object", ref.id, machine_id(), timeout=rem)
        if kind == "locator":
            addr = tuple(payload)
            reply = self.clients.get(addr).call(
                "fetch_object", ref.id, machine_id(), timeout=60.0)
            self._consume_fetch_reply(ref.id, reply, addr)
        else:
            self._consume_fetch_reply(ref.id, (kind, payload), tuple(owner))

    def _consume_fetch_reply(self, object_id: str, reply,
                             src_addr: Tuple[str, int]) -> None:
        """Handle a fetch_object/resolve_object reply; 'stream' replies
        are pulled down in bounded chunks (reference pull_manager.cc — a
        multi-GB object must never ride one RPC frame)."""
        kind, payload = reply
        if kind != "stream":
            self._store_fetched(object_id, kind, payload)
            return
        meta, total, sizes = payload
        data = bytearray(total)
        client = self.clients.get(src_addr)
        pos = 0
        while pos < total:
            n = min(_fetch_chunk(), total - pos)
            chunk = client.call("fetch_object_range", object_id, pos, n,
                                timeout=60.0)
            data[pos:pos + len(chunk)] = chunk
            if not chunk:
                raise exc.ObjectLostError(object_id,
                                          "holder returned empty chunk")
            pos += len(chunk)
        views, off = [], 0
        mv = memoryview(data)
        for s in sizes:
            views.append(mv[off:off + s])
            off += s
        self.store.put_serialized(object_id, meta, views, copy=False)

    def _store_fetched(self, object_id: str, kind: str, payload) -> None:
        if kind == "inline":
            meta, bufs = payload
            self.store.put_serialized(object_id, meta,
                                      [memoryview(b) for b in bufs])
        elif kind == "shm":
            meta, shm_name, layout = payload
            self.store.put_shm_reference(object_id, meta, shm_name, layout)
        elif kind == "error":
            raise payload if isinstance(payload, exc.RayTpuError) else \
                exc.ObjectLostError(object_id, str(payload))
        else:
            raise ValueError(f"bad fetch kind {kind}")

    def _lineage_retries(self, object_id: str) -> int:
        with self._state_lock:
            spec = self._lineage.get(object_id)
        return spec.max_retries if spec is not None else 0

    def _try_reconstruct(self, ref: ObjectRef) -> bool:
        """Re-execute the producing task (lineage reconstruction)."""
        with self._state_lock:
            spec = self._lineage.get(ref.id)
            if spec is None or spec.max_retries <= 0:
                return False
            spec.max_retries -= 1
            for oid in spec.return_ids:
                self._locators.pop(oid, None)
                self._pending_ids.add(oid)
        # the resubmission's job will decref when it settles:
        # re-pin the args so the pair stays balanced
        from . import refcount

        refcount.tracker.wire_incref(
            refcount.collect_refs(spec.args, spec.kwargs))
        for oid in spec.return_ids:
            self.store.invalidate(oid)
        job = _Job(spec, self._lease_key(spec))
        self._register_inflight(spec.return_ids, job.future)
        self._start_job(job)
        return True

    def _register_inflight(self, return_ids: List[str], fut: Future) -> None:
        with self._state_lock:
            for oid in return_ids:
                if oid in self._pending_ids:  # may already have completed
                    self._inflight[oid] = fut

    # -------------------------------------------------------------- wait

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        refs = list(refs)
        seen = set()
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError("wait() expects ObjectRefs")
            if r.id in seen:
                raise ValueError("wait() requires distinct refs")
            seen.add(r.id)
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        # Push-driven: each remote ref costs at most ONE subscribe_object
        # RPC; after that the owner pushes object_available and readiness
        # checks are purely local. The bounded wait_change handles lost
        # wakes; the ~5s re-subscribe heals lost PUSHES (owner's notify hit
        # a transient connection drop after it already forgot the waiter,
        # or the owner restarted) — without it a single failed push would
        # wedge this waiter forever.
        # fast path first: enough already-ready refs (or a zero timeout)
        # must not pay the lease park/unpark RPC pair — polling loops
        # call wait(timeout=0) hot
        ready_ids: set = {r.id for r in refs if self._ref_ready(r)}
        idle_cycles = 0
        if len(ready_ids) >= num_returns or (
                deadline is not None and time.monotonic() >= deadline):
            return self._wait_split(refs, ready_ids, num_returns)
        with self._lease_released_while_blocked():
            while True:
                progressed = False
                for r in refs:
                    if r.id not in ready_ids and self._ref_ready(r):
                        ready_ids.add(r.id)
                        progressed = True
                if len(ready_ids) >= num_returns or (
                        deadline is not None
                        and time.monotonic() >= deadline):
                    break
                idle_cycles = 0 if progressed else idle_cycles + 1
                if idle_cycles >= 20:  # ~5s of silence: re-probe owners
                    idle_cycles = 0
                    with self._state_lock:
                        for r in refs:
                            if r.id not in ready_ids:
                                self._subscribed.discard(r.id)
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                self.store.wait_change(
                    0.25 if rem is None else max(0.0, min(0.25, rem)))
        return self._wait_split(refs, ready_ids, num_returns)

    @staticmethod
    def _wait_split(refs, ready_ids: set, num_returns: int):
        ready = [r for r in refs if r.id in ready_ids]
        ready = ready[:num_returns]
        # preserve original order among not_ready (extra ready refs stay)
        not_ready = [r for r in refs
                     if r.id not in {x.id for x in ready}]
        return ready, not_ready

    def _ref_ready(self, ref: ObjectRef) -> bool:
        if self.store.contains(ref.id) or self._locator_of(ref.id) is not None:
            with self._state_lock:  # value landed locally: drop push state
                self._remote_ready.discard(ref.id)
                self._subscribed.discard(ref.id)
            return True
        with self._state_lock:
            if ref.id in self._remote_ready:
                return True
        if self._is_pending_local(ref.id):
            return False
        owner = ref.owner
        if owner is None or tuple(owner) == self.address:
            return False
        with self._state_lock:
            if ref.id in self._subscribed:
                return False  # owner's push will wake the store cv
            self._subscribed.add(ref.id)
        try:
            ready = bool(self.clients.get(tuple(owner)).call(
                "subscribe_object", ref.id, self.address, timeout=5.0))
        except (ConnectionLost, RemoteError, TimeoutError):
            # TimeoutError too: a GIL-bound owner answering late must not
            # leave ref.id wedged in _subscribed with no push coming
            with self._state_lock:
                self._subscribed.discard(ref.id)
            return False
        if ready:
            with self._state_lock:
                self._remote_ready.add(ref.id)
        return ready

    def _notify_object_waiters(self, object_ids: Sequence[str]) -> None:
        """Owner-side: push readiness (value OR error recorded) to every
        wait() subscriber of these ids, then forget them."""
        targets: Dict[Tuple[str, int], List[str]] = {}
        with self._state_lock:
            for oid in object_ids:
                for addr in self._object_waiters.pop(oid, ()):
                    targets.setdefault(addr, []).append(oid)
        for addr, oids in targets.items():
            try:
                self.clients.get(addr).notify("object_available", oids)
            except Exception:  # noqa: BLE001 — waiter gone: nothing to wake
                pass

    # -------------------------------------------------------- task submission

    def submit_task(self, fn, args: tuple, kwargs: dict, *,
                    name: str = "", num_returns: int = 1,
                    resources: Optional[Dict[str, float]] = None,
                    max_retries: int = DEFAULT_MAX_RETRIES,
                    scheduling_strategy: Any = "DEFAULT",
                    placement_group_id: Optional[str] = None,
                    runtime_env: Optional[Dict[str, Any]] = None,
                    fn_bytes: Optional[bytes] = None):
        runtime_env = self._prepare_runtime_env(runtime_env)
        return_ids = [ObjectID().hex() for _ in range(num_returns)]
        spec = TaskSpec(
            task_id=TaskID().hex(),
            name=name or getattr(fn, "__name__", "task"),
            fn_bytes=fn_bytes if fn_bytes is not None
            else serialization.dumps(fn),
            args=args, kwargs=kwargs,
            return_ids=return_ids,
            resources=dict(resources or {}),
            max_retries=max_retries,
            owner=self.address,
            scheduling_strategy=scheduling_strategy,
            placement_group_id=placement_group_id,
            runtime_env=runtime_env,
            traceparent=_current_traceparent())
        refs = [ObjectRef(oid, locator=None, owner=self.address)
                for oid in return_ids]
        from . import refcount

        refcount.tracker.wire_incref(refcount.collect_refs(args, kwargs))
        with self._state_lock:
            for oid in return_ids:
                self._lineage[oid] = spec
                self._pending_ids.add(oid)
        job = _Job(spec, self._lease_key(spec))
        self._register_inflight(return_ids, job.future)
        self._start_job(job)
        return refs[0] if num_returns == 1 else refs

    def _prepare_runtime_env(self, runtime_env: Optional[Dict[str, Any]]
                             ) -> Optional[Dict[str, Any]]:
        """The job's runtime_env under `runtime_env`, validated and
        staged through the conductor's KV (None when both are empty)."""
        from . import runtime_env as renv

        env = renv.merge(self.job_runtime_env, runtime_env)
        return renv.prepare(self.conductor, env) if env else None

    # ------------------------------------------------- normal-task flow

    def _start_job(self, job: _Job) -> None:
        """Queue `job` under its lease key once its arguments exist. A
        task with an unresolved ObjectRef argument waits on the
        dependency pool first, so a waiting chain delays no independent
        task."""
        if all(self.store.contains(d.id) or self._locator_of(d.id)
               for d in job.deps):
            self._enqueue(job)
        else:
            self._dep_pool.submit(self._guarded, job, self._await_deps)

    def _await_deps(self, job: _Job) -> None:
        for dep in job.deps:
            self._wait_dep_ready(
                dep,
                should_abort=lambda: self._is_cancelled(job.spec.return_ids))
        if self._is_cancelled(job.spec.return_ids):
            # cancelled during the wait: stop here, before any lease fetch
            raise exc.TaskCancelledError(job.spec.name)
        self._enqueue(job)

    def _guarded(self, job: _Job, fn, *args) -> None:
        """Run one step of `job`; whatever it raises settles the job
        (once: a job already settled keeps its result)."""
        try:
            fn(job, *args)
        except BaseException as e:  # noqa: BLE001 — deliver to waiters
            if not job.future.done():
                self._fail_job(job, e)

    def _on_done_pool(self, job: _Job, fn, *args) -> None:
        """Run `_guarded(job, fn, *args)` on the completion pool."""
        try:
            self._done_pool.submit(self._guarded, job, fn, *args)
        except RuntimeError:  # shutting down: nobody waits any more
            pass

    def _enqueue(self, job: _Job) -> None:
        with self._lease_cv:
            self._ready.setdefault(job.key, deque()).append(job)
        self._pump(job.key)

    def _pump(self, key: tuple) -> None:
        """Send the key's queued tasks onto its cached leases. With none
        cached, start one lease fetch: more than one per key would park
        conductor threads while leases come back idle (measured before:
        the last 8 tasks of a 300-task burst at ~25 tasks/s). A key whose
        leases are not reused (SPREAD) fetches one per task. Nothing here
        raises for a task: each failure settles its own task."""
        cacheable = self._lease_cacheable(key)
        while True:
            lease = None
            with self._lease_cv:
                q = self._ready.get(key)
                if not q or self._shutdown:
                    return
                if not cacheable:
                    job = q.popleft()
                else:
                    entries = self._lease_cache.get(key)
                    if entries:
                        job = q.popleft()
                        worker_id, address, _ = entries.pop()
                        lease = (worker_id, address)
                    elif self._lease_fetching.get(key):
                        return
                    else:
                        self._lease_fetching[key] = True
                        job = q[0]  # the fetch's locality hint; stays queued
            if lease is not None and self._is_cancelled(job.spec.return_ids):
                self._lease_recache(key, *lease, pump=False)
                self._fail_job(job, exc.TaskCancelledError(job.spec.name))
            elif lease is not None:
                self._push(job, *lease)
            else:
                self._fetch_lease(job, cacheable)
                if cacheable:
                    return

    def _fetch_lease(self, job: _Job, cacheable: bool) -> None:
        """Ask the conductor for one lease without waiting; the grant (or
        the error) is settled by `_leased` on the completion pool."""
        spec = job.spec

        def on_reply(p) -> None:
            self._on_done_pool(job, self._leased, cacheable, p.ok, p.payload)

        try:
            self.conductor.call_async(
                on_reply, "lease_worker", spec.resources,
                spec.placement_group_id, None, spec.scheduling_strategy,
                self._arg_locations(job.deps))
        except BaseException as e:  # noqa: BLE001 — settled as a reply
            self._on_done_pool(job, self._leased, cacheable, False, (e, ""))

    def _leased(self, job: _Job, cacheable: bool, ok: bool, payload) -> None:
        """Completion pool: a lease fetch's reply. For a cacheable key the
        lease goes to the cache and the pump hands it to the queue's head
        (`job` only gave the locality hint); otherwise it carries `job`,
        which was taken off its queue. A lost conductor connection is
        retried while `job` has retries left; any other error fails it."""
        if ok:
            worker_id, address = payload
            if cacheable:
                with self._lease_cv:
                    self._lease_fetching[job.key] = False
                self._lease_recache(job.key, worker_id, address)
            elif self._is_cancelled(job.spec.return_ids):
                self._lease_recache(job.key, worker_id, address)
                raise exc.TaskCancelledError(job.spec.name)
            else:
                self._push(job, worker_id, address)
            return
        # (exc, remote traceback); the traceback is empty for a local
        # failure (the connection's loss, a request that was not sent)
        e = RemoteError(*payload) if payload[1] else payload[0]
        retry = (isinstance(e, ConnectionLost) and job.retries > 0
                 and not self._shutdown)
        if retry:
            job.retries -= 1
        queued = not cacheable
        with self._lease_cv:
            if cacheable:
                self._lease_fetching[job.key] = False
                q = self._ready.get(job.key)
                queued = q is not None and any(j is job for j in q)
                if queued and not retry:
                    q.remove(job)
        if queued and not retry:
            self._fail_job(job, e)
        elif retry and not cacheable:
            self._enqueue(job)
        if cacheable:
            self._pump(job.key)

    def _push(self, job: _Job, worker_id: str, address) -> None:
        """Send `job` to its leased worker without waiting: the reply (or
        the connection's loss) settles it on the completion pool. A task
        that cannot be sent at all (an argument that does not serialize)
        fails alone and gives its lease back to the key."""
        spec = job.spec
        address = tuple(address)
        with self._state_lock:
            for oid in spec.return_ids:
                self._executing_at[oid] = address
        t0 = time.time()

        def on_reply(p) -> None:
            self._on_done_pool(job, self._settle, worker_id, address, t0,
                               p.ok, p.payload)

        try:
            self.clients.get(address).call_async(
                on_reply, "push_task", self._wire_spec(spec))
        except ConnectionLost as e:
            self._on_done_pool(job, self._settle, worker_id, address, t0,
                               False, (e, ""))
        except BaseException as e:  # noqa: BLE001 — this task's own fault
            with self._state_lock:
                for oid in spec.return_ids:
                    self._executing_at.pop(oid, None)
            self._lease_recache(job.key, worker_id, address, pump=False)
            self._fail_job(job, e)

    def _settle(self, job: _Job, worker_id: str, address, t0: float,
                ok: bool, payload) -> None:
        """Completion pool: record a push's reply, then hand the lease to
        the key's next task."""
        spec = job.spec
        with self._state_lock:
            for oid in spec.return_ids:
                self._executing_at.pop(oid, None)
        if not ok and isinstance(payload[0], ConnectionLost):
            # worker gone (crash or force-cancel kill): the lease is dead
            # — release its resources at the conductor, never recache
            try:
                self.conductor.notify("return_worker", worker_id)
            except ConnectionLost:
                pass
            self._after_crash(job, worker_id)
            return
        if not ok:
            self._lease_recache(job.key, worker_id, address)
            raise RemoteError(*payload)
        # record ALWAYS: cancelled ids are skipped inside (their caller
        # already holds TaskCancelledError) but sibling return values of a
        # multi-return task must still be delivered
        skipped = self._record_results(spec.return_ids, payload,
                                       holder=address)
        if skipped:
            status = "CANCELLED"
        else:
            status = "FAILED" if any(entry[1] == "error"
                                     for entry in payload) else "FINISHED"
        self._record_event(spec, t0, address, status)
        self._finish_job(job)
        self._lease_recache(job.key, worker_id, address)

    def _after_crash(self, job: _Job, worker_id: str) -> None:
        """A push lost its worker. Retry on a new lease while retries
        last; a force-cancel kill is the requested outcome."""
        spec = job.spec
        if self._is_cancelled(spec.return_ids):
            raise exc.TaskCancelledError(spec.name)
        err = self._worker_crash_error(worker_id, spec.name)
        if job.retries <= 0 or self._shutdown:
            raise err
        job.retries -= 1
        self._enqueue(job)

    def _fail_job(self, job: _Job, e: BaseException) -> None:
        spec = job.spec
        if isinstance(e, RemoteError) and isinstance(
                e.cause, exc.RayTpuError):
            # e.g. SchedulingError from a hard NodeAffinity lease —
            # surface the typed error, not an opaque RPC wrapper
            e = e.cause
        err = e if isinstance(e, exc.RayTpuError) else exc.TaskError(
            e, "".join(traceback.format_exception(type(e), e,
                                                  e.__traceback__)),
            spec.name)
        for oid in spec.return_ids:
            self.store.put_error(oid, err)
        with self._state_lock:
            self._pending_ids.difference_update(spec.return_ids)
            self._cancelled.difference_update(spec.return_ids)
            for oid in spec.return_ids:
                self._inflight.pop(oid, None)
        self._notify_object_waiters(spec.return_ids)
        # infrastructure failures (worker crash, lease failure) must show
        # up in `summary`/`timeline` as FAILED too — but a cancel before
        # the push is CANCELLED, same as one landing after it
        status = "CANCELLED" if isinstance(e, exc.TaskCancelledError) \
            else "FAILED"
        self._record_event(spec, time.time(), None, status)
        self._finish_job(job)

    def _finish_job(self, job: _Job) -> None:
        # release the in-flight pins taken at submission — success or
        # failure, the receiver's adoption window has closed
        from . import refcount

        refcount.tracker.wire_decref(
            refcount.collect_refs(job.spec.args, job.spec.kwargs))
        if not job.future.done():
            job.future.set_result(None)

    def _drop_queued(self, oid: str) -> None:
        """Take a cancelled task off its ready queue (it holds no lease)."""
        found = None
        with self._lease_cv:
            for q in self._ready.values():
                for job in q:
                    if oid in job.spec.return_ids:
                        found = job
                        break
                if found is not None:
                    q.remove(found)
                    break
        if found is not None:
            self._fail_job(found, exc.TaskCancelledError(found.spec.name))

    def _is_cancelled(self, return_ids) -> bool:
        with self._state_lock:
            return any(oid in self._cancelled for oid in return_ids)

    # ------------------------------------------------- worker-lease reuse

    def _lease_key(self, spec: TaskSpec) -> tuple:
        """Cache key under which a granted lease is reusable: same
        resource shape, scheduling strategy and placement group."""
        strat = spec.scheduling_strategy
        if isinstance(strat, (tuple, list)):
            strat = tuple(strat)
        return (tuple(sorted(spec.resources.items())), strat,
                spec.placement_group_id)

    @staticmethod
    def _lease_cacheable(key: tuple) -> bool:
        """SPREAD tasks must get a FRESH placement decision per task
        (emptiest node — reference spread_scheduling_policy.cc); reusing
        a cached lease would pack consecutive tasks onto whichever node
        answered first. Everything else (DEFAULT pack, NodeAffinity
        pins) is placement-stable and safe to reuse."""
        return key[1] != "SPREAD"

    def _lease_recache(self, key: tuple, worker_id: str,
                       address: Tuple[str, int], pump: bool = True) -> None:
        """Keep a lease for reuse and (with `pump`) hand it to the key's
        queued tasks; a SPREAD lease or one at shutdown goes back."""
        if self._shutdown or not self._lease_cacheable(key):
            try:
                self.conductor.notify("return_worker", worker_id)
            except ConnectionLost:
                pass
            return
        with self._lease_cv:
            self._lease_cache.setdefault(key, []).append(
                (worker_id, tuple(address), time.monotonic()))
            self._lease_cv.notify_all()
            start_reaper = not self._lease_reaper_started
            if start_reaper:
                self._lease_reaper_started = True
        if start_reaper:
            threading.Thread(target=self._lease_reaper_loop, daemon=True,
                             name="lease-reaper").start()
        if pump:
            self._pump(key)

    def _lease_reaper_loop(self) -> None:
        """Return leases idle beyond the TTL so cached workers are only
        held while this driver is actively pipelining — other drivers'
        lease_worker calls see at most one TTL of extra wait."""
        ttl = _lease_idle_ttl()
        while not self._shutdown:
            time.sleep(min(0.05, ttl / 2))
            now = time.monotonic()
            expired = []
            with self._lease_cache_lock:
                for key in list(self._lease_cache):
                    keep = []
                    for wid, addr, t in self._lease_cache[key]:
                        if now - t > ttl:
                            expired.append(wid)
                        else:
                            keep.append((wid, addr, t))
                    if keep:
                        self._lease_cache[key] = keep
                    else:
                        del self._lease_cache[key]
            for wid in expired:
                try:
                    self.conductor.notify("return_worker", wid)
                except ConnectionLost:
                    # transient (reconnecting client): the conductor will
                    # reclaim the worker via its own liveness tracking —
                    # keep reaping, a dead reaper would pin future leases
                    pass

    def _return_all_cached_leases(self) -> None:
        with self._lease_cache_lock:
            entries = [wid for lst in self._lease_cache.values()
                       for wid, _, _ in lst]
            self._lease_cache.clear()
        for wid in entries:
            try:
                self.conductor.notify("return_worker", wid)
            except ConnectionLost:
                return

    def _worker_crash_error(self, worker_id: str,
                            task_name: str) -> exc.WorkerCrashedError:
        """Typed error for a worker dying mid-task: the memory monitor
        records 'oom: ...' BEFORE killing locally, and agent OOM kills
        arrive with the next heartbeat — so query, once immediately and
        once after a short grace, before settling for a generic crash."""
        cause = None
        for delay in (0.0, 0.3):
            if delay:
                time.sleep(delay)
            try:
                cause = self.conductor.call("worker_death_cause", worker_id,
                                            timeout=5.0)
            except (ConnectionLost, TimeoutError, RemoteError):
                break
            if cause is not None:
                break
        if cause and cause.startswith("oom"):
            return exc.OutOfMemoryError(
                f"worker {worker_id[:12]}… was OOM-killed running "
                f"{task_name} — {cause}")
        return exc.WorkerCrashedError(
            f"worker {worker_id[:12]}… died running {task_name}"
            + (f" ({cause})" if cause else ""))

    def _wire_spec(self, spec: TaskSpec) -> dict:
        # "machine" tells the executor whether a shm-name result reply is
        # attachable by us (same host) or must come back as a locator we
        # fetch through the machine-id-aware chunked path
        return {"task_id": spec.task_id, "name": spec.name,
                "fn_bytes": spec.fn_bytes, "args": spec.args,
                "kwargs": spec.kwargs, "return_ids": spec.return_ids,
                "owner": spec.owner, "machine": machine_id(),
                "runtime_env": spec.runtime_env,
                "traceparent": spec.traceparent}

    def _record_results(self, return_ids: List[str], reply: list,
                        holder: Optional[Tuple[str, int]] = None) -> set:
        """Record a task/actor-call reply; returns the subset of ids that
        were cancelled (skipped — their caller already holds
        TaskCancelledError). Settles ALL ids: pending/inflight/cancelled
        bookkeeping is cleared whether cancelled or not."""
        with self._state_lock:
            cancelled = {oid for oid in return_ids if oid in self._cancelled}
        for oid, kind, payload in reply:
            if oid in cancelled:
                continue  # caller already holds TaskCancelledError
            if kind == "locator":
                with self._state_lock:
                    self._locators[oid] = tuple(payload)
            elif kind == "error":
                self.store.put_error(oid, payload)
            else:
                self._store_fetched(oid, kind, payload)
                if kind == "shm" and holder is not None:
                    # same-host large result: our entry is a zero-copy
                    # REFERENCE into the executor's memory — remember who
                    # holds the bytes so refcount-zero can free them (and
                    # so an evicted reference can refetch)
                    with self._state_lock:
                        self._locators[oid] = tuple(holder)
        with self._state_lock:
            self._pending_ids.difference_update(return_ids)
            self._cancelled.difference_update(return_ids)
            for oid in return_ids:
                self._inflight.pop(oid, None)
        # locator-only results create no store entry: wake waiters so
        # _wait_result re-checks the pending set and moves on to fetch
        self.store.notify_waiters()
        self._notify_object_waiters(return_ids)
        # results whose every handle died while the task was in flight
        # are freed right here (refcounting dead-pending path)
        from . import refcount

        for oid in return_ids:
            if refcount.tracker.was_freed_pending(oid):
                refcount.tracker.on_result_recorded(oid)
        return cancelled

    def _arg_locations(self, deps) -> Optional[List[Tuple[Tuple[str, int],
                                                          int]]]:
        """(holder_address, nbytes) per arg ref — the conductor's
        locality signal (reference core_worker/lease_policy.cc: lease
        from the raylet holding the most argument bytes). Size is 0 when
        only a remote locator is known (presence still counts)."""
        locs = []
        for dep in deps:
            addr = self._locator_of(dep.id) or dep.locator
            nbytes = self.store.size_of(dep.id)
            if addr is None and nbytes > 0:
                addr = self.address  # value lives in this process
            if addr is not None:
                locs.append((tuple(addr), int(nbytes)))
        return locs or None

    def _wait_dep_ready(self, ref: ObjectRef, should_abort=None) -> None:
        """Block until `ref`'s value exists somewhere reachable.

        Bounded wait + re-check: every blocking step caps at ~2s, so a
        dependency-pool thread is never pinned by one unbounded RPC — 16
        tasks each waiting forever on a borrowed dep would stall every
        later dependent. Between steps the loop re-checks local state,
        shutdown, and `should_abort` (task cancellation).
        """
        while True:
            if self.store.contains(ref.id) or self._locator_of(ref.id):
                return
            if self._shutdown or (should_abort is not None
                                  and should_abort()):
                return
            if self._is_pending_local(ref.id):
                self.store.wait_ready(ref.id, 0.2)
                continue
            owner = ref.owner
            if owner is None or tuple(owner) == self.address:
                # nothing to wait on; executor fetch will surface errors
                return
            # owner-side wait bounded at 2s per round trip; False means
            # "still pending" — loop and re-check. A TimeoutError is
            # owner-side queueing (its handler pool is busy), not a task
            # failure: re-poll.
            try:
                if self.clients.get(tuple(owner)).call(
                        "resolve_object_location", ref.id, 2.0,
                        timeout=15.0):
                    return
            except TimeoutError:
                continue

    def _record_event(self, spec: TaskSpec, t0: float, address,
                      status: str = "FINISHED") -> None:
        self._record_event_raw(spec.task_id, spec.name, t0, address, status)

    def _record_event_raw(self, task_id: str, name: str, t0: float,
                          address, status: str) -> None:
        ev = {"task_id": task_id, "name": name, "start": t0,
              "end": time.time(),
              "worker": tuple(address) if address else None,
              "job_id": self.job_id, "status": status}
        with self._task_events_lock:
            self._task_events.append(ev)
            n = len(self._task_events)
        if n >= 50:
            self._flush_task_events()

    def _flush_task_events(self) -> None:
        """Push buffered events to the conductor (size-triggered above,
        time-triggered by the flusher thread — external consumers like
        the dashboard must see small workloads too; reference
        task_event_buffer.cc periodic flush)."""
        with self._task_events_lock:
            batch, self._task_events = self._task_events, []
        if batch:
            try:
                self.conductor.notify("report_task_events", batch)
            except ConnectionLost:
                pass
        tracing = loaded("util.tracing")
        spans = tracing.drain() if tracing is not None else None
        if spans:
            try:
                self.conductor.notify("report_spans", spans)
            except ConnectionLost:
                pass

    def _event_flush_loop(self) -> None:
        while not self._shutdown:
            time.sleep(2.0)
            # re-check after the sleep: a stale flusher of a torn-down
            # Worker must not drain the process-global span buffer into
            # its dead conductor (drops the next cluster's spans)
            if not self._shutdown:
                self._flush_task_events()

    # ------------------------------------------------------------ execution

    def _load_task_fn(self, fn_bytes: bytes):
        """Deserialize a pushed task function, memoized on the exact
        byte string (the submitter serializes each RemoteFunction once,
        so repeat tasks arrive with identical bytes — reference:
        function_manager.py caches exported functions by descriptor).
        Bounded so a driver cycling many distinct functions cannot grow
        worker memory without limit."""
        cache = getattr(self, "_fn_cache", None)
        if cache is None:
            cache = self._fn_cache = {}
        fn = cache.get(fn_bytes)
        if fn is None:
            fn = serialization.loads(fn_bytes)
            if len(cache) >= 256:
                cache.clear()
            cache[fn_bytes] = fn
        return fn

    def execute_task(self, wire: dict) -> list:
        """Run a pushed task; return reply entries (reference:
        task_execution_handler _raylet.pyx:2247; returns stored per
        core_worker.cc:3268)."""
        name = wire.get("name", "task")
        ident = threading.get_ident()
        with self._state_lock:
            for oid in wire["return_ids"]:
                self._exec_threads[oid] = ident
        try:
            try:
                fn = self._load_task_fn(wire["fn_bytes"])
                args = tuple(self._materialize(a) for a in wire["args"])
                kwargs = {k: self._materialize(v)
                          for k, v in wire["kwargs"].items()}
                from . import runtime_env as renv

                with renv.applied(self.conductor, wire.get("runtime_env")), \
                        _traced(f"task:{name}", wire.get("traceparent")):
                    result = fn(*args, **kwargs)
            except exc.TaskCancelledError as e:
                return [(oid, "error", e) for oid in wire["return_ids"]]
            except BaseException as e:  # noqa: BLE001
                err = exc.TaskError(e, traceback.format_exc(), name)
                return [(oid, "error", err) for oid in wire["return_ids"]]
            return_ids = wire["return_ids"]
            if len(return_ids) == 1:
                results = [result]
            else:
                results = list(result)
                if len(results) != len(return_ids):
                    err = exc.TaskError(
                        ValueError(
                            f"task {name} returned {len(results)} values, "
                            f"expected {len(return_ids)}"), "", name)
                    return [(oid, "error", err) for oid in return_ids]
            return [self._store_result(oid, value, wire.get("machine"))
                    for oid, value in zip(return_ids, results)]
        except exc.TaskCancelledError as e:
            # async-exc injection landed AFTER fn returned (teardown /
            # result-serialization window) — still a cancel, not a crash
            return [(oid, "error", e) for oid in wire["return_ids"]]
        finally:
            self._pop_exec_threads(wire["return_ids"])

    def _pop_exec_threads(self, return_ids, also=None) -> None:
        """Executor teardown that a pending async-exc injection must never
        skip: retry until the pops (and `also`, which must be idempotent)
        complete without interruption. Injection happens under _state_lock
        with an _exec_threads membership check, so once the pop lands no
        further injection can target this thread for these ids."""
        while True:
            try:
                with self._state_lock:
                    for oid in return_ids:
                        self._exec_threads.pop(oid, None)
                if also is not None:
                    also()
                break
            except exc.TaskCancelledError:
                continue

    def _materialize(self, v: Any) -> Any:
        return self._get_one(v, None) if isinstance(v, ObjectRef) else v

    def _store_result(self, oid: str, value: Any,
                      requester_machine: Optional[str] = None):
        try:
            nbytes = self.store.put_value(oid, value)
            meta, shm_name, layout, inline = self.store.export(oid)
        except BaseException as e:  # noqa: BLE001 — serialization failure
            return (oid, "error",
                    exc.TaskError(e, traceback.format_exc(), "store_result"))
        same_host = requester_machine is None \
            or requester_machine == machine_id()
        if shm_name is not None:
            if same_host:
                return (oid, "shm", (meta, shm_name, layout))
            # cross-host: a shm name is meaningless there — hand back a
            # locator; the caller pulls through the chunked fetch path
            return (oid, "locator", self.address)
        if nbytes <= shm_threshold():
            return (oid, "inline", (meta, inline))
        return (oid, "locator", self.address)

    # --------------------------------------------------------------- actors

    def create_actor(self, cls, args, kwargs, options: Dict[str, Any]) -> dict:
        options = dict(options)
        options["runtime_env"] = self._prepare_runtime_env(
            options.get("runtime_env"))
        spec_bytes = serialization.dumps((cls, args, kwargs, options))
        resources = dict(options.get("resources") or {})
        num_cpus = options.get("num_cpus")
        # Reference semantics: actors default to 0 CPUs while running
        # (python/ray/_private/ray_option_utils.py) so idle actors don't
        # pin cluster CPUs — this is what makes 40k actors/cluster possible
        # (release/benchmarks/README.md:10). Tasks keep the 1-CPU default.
        resources["CPU"] = 0.0 if num_cpus is None else float(num_cpus)
        from ..util import scheduling_strategies as _sched

        info = self.conductor.call(
            "create_actor", spec_bytes,
            options.get("name"), options.get("namespace", "default"),
            resources,
            options.get("max_restarts", 0),
            options.get("max_task_retries", 0),
            options.get("placement_group_id"),
            options.get("get_if_exists", False),
            _sched.to_wire(options.get("scheduling_strategy", "DEFAULT")),
            timeout=None)
        if info["state"] == "DEAD":
            raise exc.ActorDiedError(info["actor_id"],
                                     info.get("death_cause") or "")
        return info

    def submit_actor_task(self, actor_id: str, address: Tuple[str, int],
                          method: str, args: tuple, kwargs: dict,
                          num_returns: int, seqno: int, caller_id: str,
                          max_task_retries: int = 0):
        return_ids = [ObjectID().hex() for _ in range(num_returns)]
        refs = [ObjectRef(oid, locator=tuple(address), owner=self.address)
                for oid in return_ids]
        from . import refcount

        refcount.tracker.wire_incref(refcount.collect_refs(args, kwargs))
        with self._state_lock:
            self._pending_ids.update(return_ids)
        self._register_inflight(
            return_ids, self._submit_pool.submit(
                self._actor_call_bg, actor_id, tuple(address), method, args,
                kwargs, return_ids, seqno, caller_id, max_task_retries,
                _current_traceparent()))
        return refs[0] if num_returns == 1 else refs

    def _await_send_turn(self, caller_id: str, seqno: int) -> None:
        if seqno < 0:
            return
        with self._send_cv:
            self._send_seq.setdefault(caller_id, 0)
            while self._send_seq[caller_id] < seqno and not self._shutdown:
                self._send_cv.wait(0.1)

    def _advance_send_turn(self, caller_id: str, seqno: int) -> None:
        if seqno < 0:
            return
        with self._send_cv:
            if self._send_seq.get(caller_id, 0) <= seqno:
                self._send_seq[caller_id] = seqno + 1
                self._send_cv.notify_all()

    def _actor_call_bg(self, actor_id, address, method, args, kwargs,
                       return_ids, seqno, caller_id, retries,
                       traceparent=None) -> None:
        from . import refcount

        arg_refs = refcount.collect_refs(args, kwargs)
        t0 = time.time()
        ev_name = f"{actor_id[:8]}.{method}"
        try:
            while True:
                pending = client = None
                self._await_send_turn(caller_id, seqno)
                try:
                    client = self.clients.get(address)
                    pending = client.start_call(
                        "actor_task", actor_id, method, args, kwargs,
                        return_ids, seqno, caller_id, machine_id(),
                        traceparent)
                except ConnectionLost:
                    pass
                finally:
                    self._advance_send_turn(caller_id, seqno)
                if pending is None:
                    # Never delivered (connect/send failed) — always safe to
                    # wait for restart and resend, independent of
                    # max_task_retries (matches the reference's client-side
                    # queueing while an actor is RESTARTING).
                    address = self._wait_actor_restart(actor_id)
                    seqno = -1  # resent call executes unordered
                    continue
                try:
                    reply = client.finish_call(pending, "actor_task",
                                               timeout=None)
                    break
                except (ConnectionLost, RemoteError) as e:
                    unavailable = isinstance(e, ConnectionLost) or isinstance(
                        e.cause, exc.ActorUnavailableError)
                    if not unavailable:
                        raise
                    if retries == 0:
                        raise exc.ActorDiedError(
                            actor_id, "actor died mid-call "
                            "(max_task_retries=0)") from e
                    address = self._wait_actor_restart(actor_id)
                    seqno = -1  # retried call executes unordered
                    if retries > 0:
                        retries -= 1
            self._record_results(return_ids, reply, holder=tuple(address))
            # actor calls show up in the task timeline / actor
            # drill-down like plain tasks (reference task events cover
            # both NORMAL_TASK and ACTOR_TASK)
            self._record_event_raw(return_ids[0], ev_name, t0,
                                   tuple(address), "FINISHED")
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, RemoteError) and isinstance(e.cause,
                                                         exc.RayTpuError):
                err: BaseException = e.cause
            elif isinstance(e, exc.RayTpuError):
                err = e
            else:
                err = exc.TaskError(e, traceback.format_exc(), method)
            for oid in return_ids:
                self.store.put_error(oid, err)
            with self._state_lock:
                self._pending_ids.difference_update(return_ids)
                self._cancelled.difference_update(return_ids)
                for oid in return_ids:
                    self._inflight.pop(oid, None)
            self._notify_object_waiters(return_ids)
            self._record_event_raw(
                return_ids[0], ev_name, t0, tuple(address),
                "CANCELLED" if isinstance(err, exc.TaskCancelledError)
                else "FAILED")
        finally:
            refcount.tracker.wire_decref(arg_refs)

    # --------------------------------------------------------------- pubsub

    def subscribe_channel(self, channel: str, callback) -> None:
        """Route conductor pubsub `channel` messages to `callback`
        (reference: GcsSubscriber; here the conductor pushes on_published
        straight at our RPC server — no long-poll loop)."""
        with self._pub_lock:
            self._pub_handlers.setdefault(channel, []).append(callback)
            need_sub = channel not in self._pub_channels
            if need_sub:
                self._pub_channels.add(channel)
        if need_sub:
            try:
                self.conductor.call("subscribe", channel, self.address,
                                    timeout=10.0)
            except (ConnectionLost, TimeoutError, RemoteError):
                # callers all have polling fallbacks; an unreachable/slow
                # conductor must not turn a subscribe into their failure
                with self._pub_lock:
                    self._pub_channels.discard(channel)

    def unsubscribe_channel(self, channel: str, callback) -> None:
        """Drop a local callback (the conductor-side subscription is
        per-address and shared; it stays)."""
        with self._pub_lock:
            cbs = self._pub_handlers.get(channel)
            if cbs and callback in cbs:
                cbs.remove(callback)

    def _wait_actor_restart(self, actor_id: str,
                            timeout: float = 120.0) -> Tuple[str, int]:
        """Block until the actor is ALIVE again. Event-driven: rides the
        conductor's actor_state pubsub channel (reference GCS actor pubsub,
        gcs_actor_manager.cc state-change publish); the 2s re-query is only
        a safety net for a conductor restart dropping subscriptions."""
        event = threading.Event()

        def on_state(msg) -> None:
            if isinstance(msg, dict) and msg.get("actor_id") == actor_id:
                event.set()

        self.subscribe_channel("actor_state", on_state)
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                event.clear()  # before the query: a publish racing it wakes
                info = self.conductor.call("get_actor_info", actor_id,
                                           timeout=10.0)
                if info["state"] == "ALIVE":
                    return tuple(info["address"])
                if info["state"] == "DEAD":
                    raise exc.ActorDiedError(actor_id,
                                             info.get("death_cause") or "")
                event.wait(2.0)
            raise exc.ActorUnavailableError(actor_id, "restart timed out")
        finally:
            self.unsubscribe_channel("actor_state", on_state)

    # --------------------------------------------------------- cancellation

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        """Cancel the task producing `ref` (reference CoreWorker::
        CancelTask, python worker.py:2932 ray.cancel semantics):
        - not yet pushed: taken off its ready queue (or dropped when its
          dependency wait or lease fetch ends);
        - running: the executor gets a cooperative TaskCancelledError
          injection (force=True kills the worker process instead — the
          guaranteed stop, surfacing through the worker-death path);
        - queued actor call: dropped at dispatch, the actor survives
          (force=True is rejected for actor calls, as in the reference —
          it would kill the whole actor, not one call);
        - a ref owned by another process is forwarded to its owner.
        The caller's get() raises TaskCancelledError immediately either
        way; completion racing the cancel is discarded, not delivered."""
        if force and ref.locator is not None and ref.owner is not None \
                and tuple(ref.locator) != tuple(ref.owner):
            # actor-call refs are minted with locator=executor upfront;
            # task refs start locator-less, put() refs have locator==owner
            raise ValueError(
                "force=True is not supported for actor calls: it would "
                "kill the actor process, failing every other caller "
                "(reference ray.cancel ValueError)")
        owner = tuple(ref.owner) if ref.owner is not None else None
        if owner is not None and owner != self.address:
            # borrowed ref: only the owner knows where it is executing
            # (reference: CancelTask RPC routed to the owning worker)
            try:
                self.clients.get(owner).notify(
                    "cancel_owned_object", ref.id, force,
                    tuple(ref.locator) if ref.locator else None)
            except ConnectionLost:
                pass
            return
        self._cancel_owned(ref.id, force,
                           tuple(ref.locator) if ref.locator else None)

    def _cancel_owned(self, oid: str, force: bool,
                      locator: Optional[Tuple[str, int]]) -> None:
        with self._state_lock:
            still_mine = oid in self._pending_ids
            if still_mine:
                self._cancelled.add(oid)
            where = self._executing_at.get(oid)
        if not still_mine:
            return  # already finished (or not ours): nothing to cancel
        self._drop_queued(oid)
        # wake the caller NOW; execution teardown proceeds asynchronously
        self.store.put_error(oid, exc.TaskCancelledError(
            f"task for {oid[:12]}… cancelled"
            + (" (force)" if force else "")))
        self._notify_object_waiters([oid])
        if where is None and locator is not None:
            where = tuple(locator)  # actor call: executor known upfront
        if where is not None:
            try:
                self.clients.get(tuple(where)).notify(
                    "cancel_task", [oid], force)
            except ConnectionLost:
                pass

    # ------------------------------------------------------------ streaming

    def open_stream(self) -> Tuple[str, "queue.Queue"]:
        """Create a local stream endpoint. A remote producer pushes
        (seq, payload) frames at it with the stream_chunk RPC; the
        consumer drains the returned queue (serve's streaming responses,
        reference: streaming ObjectRefGenerator, replica.py:470)."""
        stream_id = uuid.uuid4().hex
        q: "queue.Queue" = queue.Queue()
        with self._state_lock:
            self._streams[stream_id] = q
        return stream_id, q

    def close_stream(self, stream_id: str) -> None:
        """Drop the endpoint; the producer's later pushes are answered
        False, so it stops generating."""
        with self._state_lock:
            self._streams.pop(stream_id, None)

    # ----------------------------------------------------------- async get

    def get_future(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self._get_one(ref, None))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    async def get_async(self, ref: ObjectRef):
        return await asyncio.wrap_future(self.get_future(ref))

    # ------------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        from . import refcount

        refcount.tracker.detach()
        # flush the tail of the task-event/span batch so `ray_tpu summary`/
        # `timeline` see short-lived drivers (e.g. submitted jobs)
        try:
            self._flush_task_events()
        except Exception:  # noqa: BLE001 — head may already be gone
            pass
        for pool in (self._submit_pool, self._dep_pool, self._done_pool):
            pool.shutdown(wait=False, cancel_futures=True)
        with self._lease_cv:
            queued = [job for q in self._ready.values() for job in q]
            self._ready.clear()
        for job in queued:
            try:
                self._fail_job(job, exc.TaskCancelledError(job.spec.name))
            except Exception:  # noqa: BLE001 — head may already be gone
                pass
        try:
            self._return_all_cached_leases()
        except Exception:  # noqa: BLE001 — conductor may already be gone
            pass
        self.server.stop()
        self.clients.close_all()
        try:
            self.conductor.close()
        except Exception:
            pass
        self.store.shutdown()


class ActorRuntime:
    """Server-side actor state: instance + ordered scheduling queue
    (reference: ActorSchedulingQueue, actor_scheduling_queue.cc — per-caller
    sequence numbers with a reorder buffer; concurrency via a pool when
    max_concurrency > 1, concurrency_group_manager.cc)."""

    def __init__(self, worker: Worker, actor_id: str, cls, args, kwargs,
                 options: Dict[str, Any]):
        self.worker = worker
        self.actor_id = actor_id
        self.options = options
        self.max_concurrency = int(options.get("max_concurrency") or 1)
        if options.get("runtime_env"):
            # a process of its own: applied for good, before the class's
            # __init__ (and so before its first CUDA call)
            from . import runtime_env as renv

            renv.applied(worker.conductor, options["runtime_env"],
                         permanent=True).__enter__()
        self.instance = cls(
            *[worker._materialize(a) for a in args],
            **{k: worker._materialize(v) for k, v in kwargs.items()})
        self._next_seqno: Dict[str, int] = {}
        self._reorder: Dict[str, Dict[int, tuple]] = {}
        self._cancelled: set = set()  # return_ids dropped before dispatch
        self._known: set = set()      # return_ids queued or executing
        # replies go out from a thread that is never an injection target
        # (not in _exec_threads): an async-exc landing mid reply-frame
        # write would corrupt the connection for every later reply
        self._reply_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"actor-reply-{actor_id[:8]}")
        self._cv = threading.Condition()
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._exec_pool = ThreadPoolExecutor(
            max_workers=self.max_concurrency,
            thread_name_prefix=f"actor-{actor_id[:8]}")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        threading.Thread(target=self._dispatch_loop, daemon=True,
                         name="actor-dispatch").start()

    def submit(self, method, args, kwargs, return_ids, seqno, caller_id,
               done_cb, caller_machine=None, traceparent=None) -> None:
        if seqno < 0:
            # unordered (post-restart retry): skip the reorder buffer —
            # ordering across a restart boundary is best-effort, matching the
            # reference's at-least-once actor-retry semantics.
            with self._cv:
                self._known.update(return_ids)
            self._queue.put((method, args, kwargs, return_ids, done_cb,
                             caller_machine, traceparent))
            return
        with self._cv:
            self._known.update(return_ids)
            # A fresh runtime (post-restart) may first see a caller mid-stream;
            # adopt its current seqno as the starting point.
            expected = self._next_seqno.setdefault(caller_id, seqno)
            buf = self._reorder.setdefault(caller_id, {})
            buf[seqno] = (method, args, kwargs, return_ids, done_cb,
                          caller_machine, traceparent)
            while expected in buf:
                self._queue.put(buf.pop(expected))
                expected += 1
            self._next_seqno[caller_id] = expected

    def _dispatch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if self.max_concurrency == 1:
                self._run_one_safe(item)
            else:
                self._exec_pool.submit(self._run_one_safe, item)
            # don't pin the last call's args while idle in queue.get()
            item = None

    def _run_one_safe(self, item) -> None:
        try:
            self._run_one(item)
        except exc.TaskCancelledError:
            # stray async-exc that fired after _run_one delivered its
            # reply: absorb it so the dispatch/pool thread survives
            pass

    def cancel(self, object_ids) -> bool:
        """Mark queued calls cancelled (dropped with TaskCancelledError at
        dispatch — the actor itself survives; reference: pending actor
        tasks cancel with TaskCancelledError, running ones are interrupted
        via the worker's async-exc path). Only ids still queued/executing
        here are marked — a cancel racing an already-delivered completion
        must not leave a permanent mark."""
        with self._cv:
            live = [oid for oid in object_ids if oid in self._known]
            self._cancelled.update(live)
        return bool(live)

    def _run_one(self, item) -> None:
        (method, args, kwargs, return_ids, done_cb, caller_machine,
         traceparent) = item
        with self._cv:
            dropped = any(oid in self._cancelled for oid in return_ids)
            self._cancelled.difference_update(return_ids)
            if dropped:
                self._known.difference_update(return_ids)
        if dropped:
            err0 = exc.TaskCancelledError(f"{method} cancelled while queued")
            done_cb([(oid, "error", err0) for oid in return_ids])
            return
        delivered = [False]

        def deliver(reply) -> None:
            # exactly-once and hang-proof: the reply is handed to the
            # reply pool (whose thread is never an injection target) and
            # the flag flips only after the handoff succeeded. A stray
            # TaskCancelledError inside submit() retries; the worst case
            # is a duplicate enqueue, and the RPC client drops replies
            # with an already-settled req_id.
            while not delivered[0]:
                try:
                    self._reply_pool.submit(done_cb, reply)
                    delivered[0] = True
                except exc.TaskCancelledError:
                    continue

        ident = threading.get_ident()
        with self.worker._state_lock:
            for oid in return_ids:
                self.worker._exec_threads[oid] = ident
        try:
            self._call_and_reply(method, args, kwargs, return_ids, deliver,
                                 caller_machine, traceparent)
        except exc.TaskCancelledError as e:
            # async-exc landed in the teardown window after the method
            # returned — deliver the cancel (no-op if already delivered)
            deliver([(oid, "error", e) for oid in return_ids])
        finally:
            # marks for calls cancelled while RUNNING (not queued) are
            # consumed alongside the pops, not leaked
            def consume_marks() -> None:
                with self._cv:
                    self._cancelled.difference_update(return_ids)
                    self._known.difference_update(return_ids)

            self.worker._pop_exec_threads(return_ids, also=consume_marks)

    def _call_and_reply(self, method, args, kwargs, return_ids, deliver,
                        caller_machine, traceparent=None) -> None:
        try:
            if method in _UNPORTED_HOOKS:
                raise NotImplementedError(_UNPORTED_HOOKS[method])
            if method == "__ray_tpu_col_init__":
                # the universal hook that lets create_collective_group
                # init a group on any actor class (reference declarative
                # mode, collective.py:151)
                from ..util import collective as _collective

                fn = _collective.init_collective_group
            else:
                fn = getattr(self.instance, method)
            args = tuple(self.worker._materialize(a) for a in args)
            kwargs = {k: self.worker._materialize(v)
                      for k, v in kwargs.items()}
            with _traced(f"actor:{type(self.instance).__name__}.{method}",
                         traceparent):
                result = fn(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = self._run_coroutine(result)
            results = [result] if len(return_ids) == 1 else list(result)
            reply = [self.worker._store_result(oid, value, caller_machine)
                     for oid, value in zip(return_ids, results)]
        except SystemExit:
            err = exc.ActorDiedError(self.actor_id, "exit_actor() called")
            deliver([(oid, "error", err) for oid in return_ids])
            self._graceful_exit()
            return
        except exc.TaskCancelledError as e:
            reply = [(oid, "error", e) for oid in return_ids]
        except BaseException as e:  # noqa: BLE001
            err2 = exc.TaskError(e, traceback.format_exc(), method)
            reply = [(oid, "error", err2) for oid in return_ids]
        deliver(reply)

    def ensure_loop(self) -> asyncio.AbstractEventLoop:
        """The actor's persistent event loop — ALL of this actor's async
        work must share it so loop-bound primitives (asyncio.Queue/Lock
        created in async methods) stay usable across calls."""
        if self._loop is None:
            self._loop = asyncio.new_event_loop()
            threading.Thread(target=self._loop.run_forever, daemon=True,
                             name="actor-asyncio").start()
        return self._loop

    def _run_coroutine(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.ensure_loop()
                                                ).result()

    def _graceful_exit(self) -> None:
        _refuse_in_driver(self.worker, "exit_actor()")
        # flush the in-flight reply (exit_actor's own ActorDiedError) —
        # os._exit would otherwise drop it before the frame hits the wire
        self._reply_pool.shutdown(wait=True)
        try:
            self.worker.conductor.call("report_actor_exit", self.actor_id,
                                       "exit_actor() called", timeout=5.0)
        except Exception:
            pass
        # Deliberately NOT unlinking the shm arena here: a consumer may
        # hold a fetched-but-not-yet-mapped reference to a block in it
        # (put_shm_reference records the segment NAME lazily); unlinking
        # would turn its first get() into ObjectLostError. The leaked
        # segment is bounded per exited actor and swept at cluster stop
        # (object_store.cleanup_leaked_segments).
        os._exit(0)


def _traced(name: str, traceparent: Optional[str]):
    """A span under the submitter's `traceparent`, or nothing when the
    wire carries none. A traceparent turns tracing on in this process:
    the submitter's switch reaches workers it did not spawn."""
    if not traceparent:
        return contextlib.nullcontext()
    from ..util import tracing

    tracing.enable()
    return tracing.span(name, traceparent=traceparent)


# actor methods the JAX package answers on every actor, whose targets
# are not ported yet
_UNPORTED_HOOKS = {
    "__ray_tpu_compiled_loop__":
        "compiled DAGs are not ported yet (ROADMAP Queue 1 item 8: dag/)",
}


class WorkerHandler:
    """RPC surface of a worker process (reference core_worker.proto:
    PushTask, GetObjectStatus, object-location queries)."""

    def __init__(self, worker: Worker):
        self.w = worker

    def ping(self) -> str:
        return "pong"

    def store_stats(self) -> dict:
        """Object-store introspection for the state API (reference
        `ray memory` / StateHead object aggregation)."""
        s = self.w.store.stats()
        s["worker_id"] = self.w.worker_id
        s["actor_id"] = getattr(self.w._actor_runtime, "actor_id", None) \
            if self.w._actor_runtime else None
        return s

    def push_task(self, wire: dict) -> list:
        return self.w.execute_task(wire)

    def become_actor(self, actor_id: str, spec_bytes: bytes) -> bool:
        stamp_startup("become_actor")
        cls, args, kwargs, options = serialization.loads(spec_bytes)
        stamp_startup("actor_spec_loaded")
        self.w._actor_runtime = ActorRuntime(self.w, actor_id, cls, args,
                                             kwargs, options)
        return True

    # actor_task is enqueued from the RPC reader thread in frame-arrival
    # order (see RpcServer._conn_loop) so the per-caller reorder buffer sees
    # seqnos arrive monotonically; the reply goes out when execution ends.
    _async_reply_methods = frozenset({"actor_task"})

    def actor_task(self, reply_cb, actor_id: str, method: str, args, kwargs,
                   return_ids, seqno: int, caller_id: str,
                   caller_machine: Optional[str] = None,
                   traceparent: Optional[str] = None) -> None:
        rt = self.w._actor_runtime
        if rt is None or rt.actor_id != actor_id:
            e = exc.ActorUnavailableError(actor_id,
                                          "no such actor on this worker")
            reply_cb(False, (e, ""))
            return
        rt.submit(method, args, kwargs, return_ids, seqno, caller_id,
                  lambda reply: reply_cb(True, reply), caller_machine,
                  traceparent)

    def fetch_object(self, object_id: str,
                     requester_machine: Optional[str] = None):
        """Serve a fetch. Same-host peers (or legacy callers passing no
        machine id) get the shm zero-copy reference; cross-host peers get
        the payload inline, or a 'stream' header directing them to pull
        fetch_object_range chunks (reference object_manager chunked
        push/pull, pull_manager.cc)."""
        same_host = requester_machine is None \
            or requester_machine == machine_id()
        try:
            if same_host:
                meta, shm_name, layout, inline = self.w.store.export(object_id)
                if shm_name is not None:
                    return ("shm", (meta, shm_name, layout))
                return ("inline", (meta, inline))
            meta, total, sizes = self.w.store.stream_info(object_id)
            if total > _fetch_chunk():
                return ("stream", (meta, total, sizes))
            data = self.w.store.read_range(object_id, 0, total)
            bufs, off = [], 0
            for s in sizes:
                bufs.append(data[off:off + s])
                off += s
            return ("inline", (meta, bufs))
        except exc.RayTpuError as e:
            return ("error", e)

    def fetch_object_range(self, object_id: str, start: int,
                           size: int) -> bytes:
        return self.w.store.read_range(object_id, start,
                                       min(size, _fetch_chunk()))

    def resolve_object(self, object_id: str,
                       requester_machine: Optional[str] = None):
        """Owner-side: block until ready, then return the value or its
        location (reference: ownership-based object directory)."""
        w = self.w
        while True:
            if w.store.contains(object_id):
                return self.fetch_object(object_id, requester_machine)
            loc = w._locator_of(object_id)
            if loc is not None:
                return ("locator", loc)
            if not w._is_pending_local(object_id):
                return ("error", exc.ObjectLostError(object_id,
                                                     "unknown to owner"))
            w.store.wait_ready(object_id, 0.2)

    def resolve_object_location(self, object_id: str,
                                max_wait: Optional[float] = None) -> bool:
        """True once the object is reachable; False if `max_wait` elapses
        while it is still legitimately pending (caller re-polls — keeps
        the requester's RPC bounded instead of parking it here)."""
        w = self.w
        deadline = None if max_wait is None else time.monotonic() + max_wait
        while True:
            if w.store.contains(object_id) or w._locator_of(object_id):
                return True
            if not w._is_pending_local(object_id):
                raise exc.ObjectLostError(object_id, "unknown to owner")
            if deadline is not None and time.monotonic() >= deadline:
                return False
            w.store.wait_ready(object_id, 0.2)

    def subscribe_object(self, object_id: str,
                         waiter: Tuple[str, int]) -> bool:
        """Register `waiter` for an object_available push when `object_id`
        resolves (value OR error); True if it is already ready, in which
        case no push will follow. Replaces object_ready polling for wait()
        (reference: WaitForObjectEviction-style owner callbacks)."""
        w = self.w
        if w.store.contains(object_id) or w._locator_of(object_id):
            return True
        with w._state_lock:
            w._object_waiters.setdefault(object_id, set()).add(tuple(waiter))
        # re-check AFTER registering: a result recorded between the first
        # check and the insert has already popped (or will never see) the
        # table entry — without this the waiter could miss its only push
        if w.store.contains(object_id) or w._locator_of(object_id):
            with w._state_lock:
                s = w._object_waiters.get(object_id)
                if s is not None:
                    s.discard(tuple(waiter))
                    if not s:
                        w._object_waiters.pop(object_id, None)
            return True
        return False

    def object_available(self, object_ids: List[str]) -> None:
        """Owner's readiness push for ids we subscribed to."""
        w = self.w
        with w._state_lock:
            w._remote_ready.update(object_ids)
            if len(w._remote_ready) > 1 << 16:
                # bounded: dropping entries only costs a re-subscribe RPC
                w._remote_ready.clear()
                w._subscribed.clear()
                w._remote_ready.update(object_ids)
        w.store.notify_waiters()

    def free_objects(self, object_ids: List[str]) -> None:
        for oid in object_ids:
            self.w.store.delete(oid)

    def stream_chunk(self, stream_id: str, seq: int, payload: bytes) -> bool:
        """A producer's push into a local stream endpoint; False tells
        the producer the consumer is gone (stop generating)."""
        with self.w._state_lock:
            q = self.w._streams.get(stream_id)
        if q is None:
            return False
        q.put((seq, payload))
        return True

    def start_device_profile(self, tag: str, device: Optional[str] = None
                             ) -> str:
        """Begin a torch.profiler trace of THIS worker process (driver
        side: util.profiling.profile_actor); returns its directory."""
        from ..util import profiling

        return profiling.start_profile(tag, device=device)

    def stop_device_profile(self) -> str:
        from ..util import profiling

        return profiling.stop_profile()

    def refcount_update(self, from_addr, entries) -> None:
        """Batched borrower incref/adopt/drop messages (reference
        reference_count.h borrower protocol)."""
        from . import refcount

        refcount.tracker.apply_remote(from_addr, entries)

    def cancel_task(self, object_ids: List[str], force: bool = False) -> bool:
        """Cancel execution of the task producing `object_ids` (reference
        CoreWorker::CancelTask / HandleCancelTask core_worker.cc).

        force=True kills this worker process — the guaranteed stop, routed
        through the normal worker-death path on the submitter/conductor.
        Otherwise a TaskCancelledError is raised asynchronously in the
        executing thread (cooperative: a thread blocked in native code,
        e.g. time.sleep, sees it only when it re-enters the interpreter —
        same best-effort contract as the reference's non-force cancel).
        Also drops matching queued actor calls."""
        if force:
            _refuse_in_driver(self.w, "a force cancel")
            # only if a target is STILL executing here: the task may have
            # finished (and this worker been leased to someone else's task)
            # between the owner reading _executing_at and this arriving —
            # killing then would take down an innocent task
            with self.w._state_lock:
                live = any(oid in self.w._exec_threads for oid in object_ids)
            if not live:
                return False
            threading.Thread(target=lambda: (time.sleep(0.05), os._exit(1)),
                             daemon=True).start()
            return True
        hit = False
        rt = self.w._actor_runtime
        if rt is not None:
            hit = rt.cancel(object_ids) or hit
        import ctypes

        # Inject while HOLDING _state_lock: the executor pops its
        # _exec_threads entry under the same lock in its teardown, so a
        # finished task can never be "hit" after its pop — the injection
        # lands in the target task's frame or its guarded teardown, never
        # in the next task reusing the pool thread.
        with self.w._state_lock:
            idents = {self.w._exec_threads.get(oid) for oid in object_ids}
            idents.discard(None)
            for ident in idents:
                n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(ident),
                    ctypes.py_object(exc.TaskCancelledError))
                if n > 1:  # hit more than one thread state: revoke
                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(ident), None)
                hit = hit or n == 1
        return hit

    def cancel_owned_object(self, object_id: str, force: bool,
                            locator) -> None:
        """A borrower's forwarded cancel for an object WE own (reference:
        CancelTask RPC arriving at the owning core worker)."""
        self.w._cancel_owned(object_id, bool(force),
                             tuple(locator) if locator else None)

    def on_published(self, channel: str, message: Any) -> None:
        """Conductor pubsub delivery: fan out to local subscribers
        registered via Worker.subscribe_channel."""
        w = self.w
        with w._pub_lock:
            cbs = list(w._pub_handlers.get(channel, ()))
        for cb in cbs:
            try:
                cb(message)
            except Exception:  # noqa: BLE001 — one bad callback ≠ all
                pass

    def shutdown_worker(self) -> None:
        _refuse_in_driver(self.w, "shutdown_worker")
        threading.Thread(target=lambda: (time.sleep(0.05), os._exit(0)),
                         daemon=True).start()
