"""Conductor: the cluster control plane, single-node core.

The port's copy of the JAX package's conductor, an analog of the
reference's GCS server + raylet scheduling (src/ray/gcs/gcs_server/
gcs_server.h:78 and src/ray/raylet/scheduling/cluster_task_manager.cc)
merged into one authority that holds the resource view and grants
worker leases directly. Workers are leased to submitters, which then
push tasks *directly* worker-to-worker (the reference's direct task
transport, direct_task_transport.h:75).

Responsibilities in this slice:
- the head node's worker pool: pre-start/spawn worker processes,
  lease/return (reference worker_pool.h:156 / PopWorker :343), parking
  the lease of a worker blocked in get()/wait();
- whole-GPU leases: a lease asking for n >= 1 whole GPUs gets a worker
  spawned cold with CUDA_VISIBLE_DEVICES naming exactly n GPUs of the
  driver's visible list; a GPU returns to the pool only after its
  process has exited (a dying process's CUDA context holds device
  memory until it exits). Host workers see no GPU
  (CUDA_VISIBLE_DEVICES="");
- actors: creation (conductor-mediated like gcs_actor_manager.cc:255),
  named actors, kill, graceful exit, restart-on-death with max_restarts;
- internal KV + pubsub (gcs_kv_manager.cc);
- task events for the state API (gcs_task_manager.cc);
- the monitor: reap dead worker processes, restart their actors.

Left for the runtime's second part (ROADMAP Queue 1): placement groups,
the node agent and remote nodes, persistence and restore, the
failure-domain tracker and the preemption watcher, the log and memory
monitors, jobs and shutdown_cluster, and the L6 report/get methods. An
RPC of those is absent: calling it raises.
"""
from __future__ import annotations

import collections
import subprocess
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import exceptions as exc
from .ids import ActorID, NodeID, WorkerID
from .rpc import ClientPool, RpcServer


def _worker_start_timeout() -> float:
    from .config import config

    return config.worker_start_timeout


def _gpus_needed(resources: Dict[str, float]) -> int:
    """Whole-GPU count a lease binds to the worker via
    CUDA_VISIBLE_DEVICES. Fractional GPU shares only count resources —
    the binding is per process, so there is nothing to bind below one
    GPU."""
    v = resources.get("GPU", 0.0)
    if v >= 1 and float(v).is_integer():
        return int(v)
    return 0


@dataclass
class WorkerRecord:
    worker_id: str
    node_id: str
    address: Optional[Tuple[str, int]] = None
    pid: Optional[int] = None
    state: str = "STARTING"  # STARTING | IDLE | BUSY | ACTOR | DEAD
    proc: Optional[Any] = None  # subprocess.Popen or worker_spawn.ForkedProc
    resources: Dict[str, float] = field(default_factory=dict)  # held while leased
    lease_node_id: Optional[str] = None
    # lease resources parked while the worker blocks in get()/wait()
    # (reference: raylet releases blocked workers' resources)
    blocked_resources: Optional[Dict[str, float]] = None
    # the pool's indices of the GPUs this process was bound to at spawn;
    # they stay bound for the process lifetime and return to the pool
    # only once it has exited
    gpu_ids: Optional[Tuple[int, ...]] = None
    # why the worker died, when the runtime knows — submitters query this
    # to raise a typed error
    death_cause: Optional[str] = None


@dataclass
class ActorRecord:
    actor_id: str
    name: Optional[str]
    namespace: str
    state: str = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
    worker_id: Optional[str] = None
    address: Optional[Tuple[str, int]] = None
    spec: Optional[bytes] = None  # pickled (cls, args, kwargs, options)
    restarts_remaining: int = 0
    max_task_retries: int = 0
    resources: Dict[str, float] = field(default_factory=dict)
    death_cause: Optional[str] = None
    num_restarts: int = 0
    # "DEFAULT" | "SPREAD" | ("NODE_AFFINITY", node_id, soft)
    scheduling_strategy: Any = "DEFAULT"


@dataclass
class NodeRecord:
    node_id: str
    total: Dict[str, float]
    available: Dict[str, float]
    alive: bool = True
    # indices into the driver's visible GPU list not bound to any live
    # worker process
    free_gpus: List[int] = field(default_factory=list)


class ConductorHandler:
    """RPC handler — every public method is remotely callable."""

    # block-by-design handlers (waiting IS their job): exempt from the
    # RPC server's slow-handler warning — see RpcServer warn_slow.
    _slow_ok_methods = frozenset({"lease_worker", "create_actor"})

    def __init__(self, resources: Dict[str, float], session_dir: str,
                 worker_env: Optional[Dict[str, str]] = None,
                 gpu_ids: Optional[Sequence[str]] = None):
        """`gpu_ids`: the driver's id of each GPU the pool counts (what
        a worker's CUDA_VISIBLE_DEVICES names), by pool index."""
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._workers: Dict[str, WorkerRecord] = {}
        self._actors: Dict[str, ActorRecord] = {}
        self._named_actors: Dict[Tuple[str, str], str] = {}  # (ns, name) -> id
        self._kv: Dict[str, Dict[bytes, bytes]] = {}
        self._subs: Dict[str, List[Tuple[str, int]]] = {}  # channel -> addrs
        self._task_events: List[Dict[str, Any]] = []
        self._session_dir = session_dir
        self._worker_env = dict(worker_env or {})
        n_gpus = int(resources.get("GPU", 0))
        self._gpu_ids = [str(g) for g in (gpu_ids if gpu_ids is not None
                                          else range(n_gpus))]
        if len(self._gpu_ids) < n_gpus:
            raise ValueError(f"{n_gpus} GPUs counted but only "
                             f"{len(self._gpu_ids)} GPU ids given")
        self._clients = ClientPool()
        self._stopped = False
        self._waiting_leases = 0
        # Parked lease_worker calls, each on its OWN condition sharing
        # self._lock. Capacity events wake exactly ONE waiter (rotating
        # for fairness) and a successful grant cascades to the next —
        # notify_all here caused a measured 6x throughput collapse once
        # waiters outnumbered workers. The 0.1s wait timeout in
        # _lease_wait_locked remains the liveness net for a missed wakeup.
        self._lease_waiter_cvs: "collections.deque" = collections.deque()
        self.address: Optional[Tuple[str, int]] = None  # set by Conductor

        self._head = NodeRecord(node_id=NodeID().hex(), total=dict(resources),
                                available=dict(resources),
                                free_gpus=list(range(n_gpus)))
        self._head_node_id = self._head.node_id
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="conductor-monitor", daemon=True)

    # ------------------------------------------------------------------ node

    def _free_worker_gpus(self, w: WorkerRecord) -> None:
        """Return an exited worker's bound GPUs to the pool. Must hold
        the lock."""
        if w.gpu_ids:
            self._head.free_gpus.extend(w.gpu_ids)
        w.gpu_ids = None

    def _reclaim_gpus_after_exit(self, w: WorkerRecord) -> None:
        """Terminate `w` and return its GPUs to the pool only once the
        process is confirmed gone: a successor bound to the same GPUs
        while the old process's CUDA context still holds them would
        start on a card with its memory taken."""
        def confirmed_gone() -> bool:
            if w.proc is None:
                return True  # no process handle: nothing runs
            try:
                if w.proc.poll() is None:
                    w.proc.terminate()
                    try:
                        w.proc.wait(timeout=8.0)
                    except subprocess.TimeoutExpired:
                        w.proc.kill()
                        w.proc.wait(timeout=8.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
            return w.proc.poll() is not None

        def reap():
            # A wedged worker keeps its GPUs parked — leaked capacity
            # beats binding a card twice. Retry with backoff.
            backoff = 1.0
            while not self._stopped:
                if confirmed_gone():
                    with self._cv:
                        self._free_worker_gpus(w)
                        self._notify_all_locked()
                    return
                time.sleep(backoff)
                backoff = min(backoff * 2, 30.0)

        threading.Thread(target=reap, daemon=True,
                         name="gpu-reaper").start()

    def cluster_resources(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._head.total)

    def available_resources(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._head.available)

    def nodes(self) -> List[Dict[str, Any]]:
        with self._lock:
            n = self._head
            return [{"node_id": n.node_id, "alive": n.alive,
                     "total": dict(n.total), "available": dict(n.available),
                     "head": True, "address": None}]

    # ---------------------------------------------------------------- workers

    def register_worker(self, worker_id: str, address: Tuple[str, int],
                        pid: int, node_id: Optional[str] = None,
                        gpu_ids: Optional[Tuple[int, ...]] = None) -> bool:
        """Returns False to tell the worker to shut itself down: the
        conductor already wrote it off (its GPUs may be bound elsewhere),
        or it announces GPUs the conductor did not bind to it."""
        with self._cv:
            w = self._workers.get(worker_id)
            if w is None or w.state == "DEAD":
                return False
            if tuple(gpu_ids or ()) != tuple(w.gpu_ids or ()):
                return False
            w.address = tuple(address)
            w.pid = pid
            if w.state == "STARTING":
                w.state = "IDLE"
            self._notify_all_locked()
            return True

    def _spawn_worker(self, gpus: Tuple[int, ...] = ()) -> WorkerRecord:
        """Start a worker (reference: WorkerPool PopWorker spawn path,
        worker_pool.h:343). A GPU worker is spawned cold with
        CUDA_VISIBLE_DEVICES naming its GPUs by the driver's ids. Caller
        holds self._lock — the lease loop cv-waits for the new worker to
        register back."""
        from .worker_spawn import ENV_GPU_INDICES, spawn_worker_process

        worker_id = WorkerID().hex()
        env_extra = None
        if gpus:
            env_extra = {
                "CUDA_VISIBLE_DEVICES": ",".join(self._gpu_ids[g]
                                                 for g in gpus),
                ENV_GPU_INDICES: ",".join(str(g) for g in gpus)}
        proc = spawn_worker_process(
            worker_id, self.address, self._session_dir,
            worker_env=self._worker_env, env_extra=env_extra,
            node_id=self._head_node_id, cold=bool(gpus))
        w = WorkerRecord(worker_id=worker_id, node_id=self._head_node_id,
                         proc=proc, gpu_ids=tuple(gpus) or None)
        self._workers[worker_id] = w
        return w

    @staticmethod
    def _acquire_resources(node: NodeRecord, req: Dict[str, float]) -> bool:
        for k, v in req.items():
            if node.available.get(k, 0.0) + 1e-9 < v:
                return False
        for k, v in req.items():
            node.available[k] = node.available.get(k, 0.0) - v
        return True

    @staticmethod
    def _release_resources(node: NodeRecord, req: Dict[str, float]) -> None:
        for k, v in req.items():
            node.available[k] = node.available.get(k, 0.0) + v

    def lease_worker(self, resources: Dict[str, float],
                     timeout: Optional[float] = None,
                     strategy: Any = "DEFAULT",
                     arg_locations=None) -> Tuple[str, Tuple[str, int]]:
        """Grant an idle worker (spawning if below capacity), holding
        `resources` against the node until return_worker. On one node
        DEFAULT and SPREAD place alike; ("NODE_AFFINITY", node_id, soft)
        pins (reference node_affinity_scheduling_policy.cc): a hard pin
        to an unknown node or one too small raises SchedulingError.
        `arg_locations` (locality hints) are accepted for the wire's
        sake; with one node they change nothing."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else _worker_start_timeout())
        resources = dict(resources or {})
        resources.setdefault("CPU", 1.0)
        with self._cv:
            self._waiting_leases += 1
            try:
                if isinstance(strategy, (tuple, list)) and strategy \
                        and strategy[0] == "NODE_AFFINITY":
                    self._check_affinity_locked(str(strategy[1]),
                                                bool(strategy[2]), resources)
                my_cv = threading.Condition(self._lock)
                self._lease_waiter_cvs.append(my_cv)
                try:
                    return self._lease_wait_locked(resources, deadline,
                                                   my_cv)
                finally:
                    try:
                        self._lease_waiter_cvs.remove(my_cv)
                    except ValueError:
                        pass
            finally:
                self._waiting_leases -= 1

    def _wake_lease_waiter_locked(self, skip=None) -> None:
        """Wake ONE parked lease waiter (rotating so consecutive events
        spread across waiters); `skip` excludes the granting thread's own
        cv during the grant cascade. Must hold self._lock."""
        for _ in range(len(self._lease_waiter_cvs)):
            cv = self._lease_waiter_cvs[0]
            self._lease_waiter_cvs.rotate(-1)
            if cv is not skip:
                cv.notify()
                return

    def _notify_all_locked(self) -> None:
        """State-change fanout: wake shared-cv waiters (actor state,
        spawn waits) plus one parked lease waiter. Must hold self._lock."""
        self._cv.notify_all()
        self._wake_lease_waiter_locked()

    def _check_affinity_locked(self, node_id: str, soft: bool,
                               resources: Dict[str, float]) -> None:
        """A hard pin must name a live node that can ever fit the
        request; a soft one falls back to the default placement."""
        target = self._head if node_id == self._head_node_id else None
        feasible = target is not None and target.alive and all(
            target.total.get(k, 0.0) + 1e-9 >= v
            for k, v in resources.items())
        if feasible or soft:
            return
        raise exc.SchedulingError(
            f"NodeAffinity(node_id={node_id!r}, soft=False) cannot be "
            "satisfied: node is "
            + ("dead or unknown" if target is None
               else f"too small for {resources}"))

    def _lease_wait_locked(self, resources, deadline, my_cv):
        node = self._head
        while True:
            if self._stopped:
                raise RuntimeError("conductor stopped")
            if self._acquire_resources(node, resources):
                w = self._take_idle_or_spawn(deadline,
                                             _gpus_needed(resources))
                if w is not None:
                    w.state = "BUSY"
                    w.resources = resources
                    w.lease_node_id = node.node_id
                    # grant cascade: capacity may remain (coalesced
                    # frees) — hand the baton to the next waiter
                    self._wake_lease_waiter_locked(skip=my_cv)
                    return w.worker_id, w.address
                self._release_resources(node, resources)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no worker available for {resources} within timeout; "
                    f"available={node.available}")
            my_cv.wait(min(remaining, 0.1))

    def _take_idle_or_spawn(self, deadline: float,
                            n_gpus: int = 0) -> Optional[WorkerRecord]:
        """Must hold lock. Returns a registered IDLE worker bound to
        exactly `n_gpus` GPUs, spawning one if needed, or None by the
        deadline. GPU workers are reused only for leases of the same GPU
        count; idle GPU workers of another count are torn down to reclaim
        their GPUs when the pool runs dry."""
        pool = self._head

        def idle():
            for w in self._workers.values():
                if w.state == "IDLE" and len(w.gpu_ids or ()) == n_gpus:
                    return w
            return None

        def try_spawn_gpu_worker() -> bool:
            if len(pool.free_gpus) < n_gpus:
                # Reclaim GPUs bound to idle workers of other counts; they
                # return to the pool only once the old process has exited
                # (_reclaim_gpus_after_exit), and the reaper's notify
                # retries the spawn.
                prospective = len(pool.free_gpus) + sum(
                    len(w.gpu_ids or ()) for w in self._workers.values()
                    if w.state == "DEAD" and w.gpu_ids)
                for w in list(self._workers.values()):
                    if prospective >= n_gpus:
                        break
                    if w.state == "IDLE" and w.gpu_ids and \
                            len(w.gpu_ids) != n_gpus:
                        w.state = "DEAD"
                        prospective += len(w.gpu_ids)
                        self._reclaim_gpus_after_exit(w)
            if len(pool.free_gpus) < n_gpus:
                return False
            gpus = tuple(sorted(pool.free_gpus)[:n_gpus])
            for g in gpus:
                pool.free_gpus.remove(g)
            self._spawn_worker(gpus)
            return True

        w = idle()
        if w is not None:
            return w
        if n_gpus > 0:
            spawned = try_spawn_gpu_worker()
            while time.monotonic() < deadline and not self._stopped:
                w = idle()
                if w is not None:
                    return w
                if not spawned:
                    spawned = try_spawn_gpu_worker()
                self._cv.wait(0.05)
            return None
        n_starting = sum(1 for w in self._workers.values()
                         if w.state == "STARTING" and not w.gpu_ids)
        # spawn enough for every lease currently waiting (parallel cold-start)
        want = max(1, self._waiting_leases)
        for _ in range(max(0, want - n_starting)):
            self._spawn_worker()
        while time.monotonic() < deadline and not self._stopped:
            w = idle()
            if w is not None:
                return w
            self._cv.wait(0.05)
        return None

    def return_worker(self, worker_id: str) -> None:
        with self._cv:
            w = self._workers.get(worker_id)
            if w is None or w.state == "DEAD":
                return
            self._release_resources(self._head, w.resources)
            w.resources = {}
            w.blocked_resources = None  # a parked lease dies with the task
            if w.state == "BUSY":
                w.state = "IDLE"
            self._notify_all_locked()

    def worker_blocked(self, worker_id: str) -> None:
        """A worker's executor thread entered a blocking get()/wait():
        its lease resources return to the pool so the tasks it is
        waiting ON can schedule (reference: node_manager.cc
        HandleWorkerBlocked)."""
        with self._cv:
            w = self._workers.get(worker_id)
            if w is None or w.state != "BUSY" or not w.resources \
                    or w.blocked_resources:
                return
            self._release_resources(self._head, w.resources)
            w.blocked_resources = w.resources
            w.resources = {}
            self._notify_all_locked()

    def worker_unblocked(self, worker_id: str) -> None:
        """Re-take the parked lease on wake. Transient oversubscription
        is allowed (availability may go negative, stalling new leases
        until it recovers) — the reference's resume semantics."""
        with self._cv:
            w = self._workers.get(worker_id)
            if w is None or not w.blocked_resources or w.state != "BUSY":
                return
            for k, v in w.blocked_resources.items():
                self._head.available[k] = self._head.available.get(k, 0.0) - v
            w.resources = w.blocked_resources
            w.blocked_resources = None
            self._notify_all_locked()

    def prestart_workers(self, n: int) -> None:
        with self._cv:
            for _ in range(n):
                self._spawn_worker()

    def list_workers(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"worker_id": w.worker_id, "state": w.state, "pid": w.pid,
                     "address": w.address, "node_id": w.node_id,
                     "lease_node_id": w.lease_node_id,
                     "gpu_ids": list(w.gpu_ids or ())}
                    for w in self._workers.values()]

    # ----------------------------------------------------------------- actors

    def create_actor(self, spec_bytes: bytes, name: Optional[str],
                     namespace: str, resources: Dict[str, float],
                     max_restarts: int, max_task_retries: int,
                     get_if_exists: bool = False,
                     scheduling_strategy: Any = "DEFAULT") -> Dict[str, Any]:
        """GCS-mediated actor creation (reference gcs_actor_manager.cc:255,280)."""
        with self._cv:
            if name is not None:
                existing = self._named_actors.get((namespace, name))
                if existing is not None:
                    rec = self._actors[existing]
                    if rec.state != "DEAD":
                        if get_if_exists:
                            return self._actor_info_locked(rec)
                        raise ValueError(
                            f"actor name {name!r} already taken in namespace "
                            f"{namespace!r}")
            actor_id = ActorID().hex()
            rec = ActorRecord(actor_id=actor_id, name=name, namespace=namespace,
                              spec=spec_bytes,
                              restarts_remaining=max_restarts,
                              max_task_retries=max_task_retries,
                              resources=dict(resources or {}),
                              scheduling_strategy=scheduling_strategy)
            self._actors[actor_id] = rec
            if name is not None:
                self._named_actors[(namespace, name)] = actor_id
        self._place_actor(actor_id)
        with self._lock:
            return self._actor_info_locked(self._actors[actor_id])

    def _place_actor(self, actor_id: str) -> None:
        """Lease a dedicated worker and instantiate the actor on it."""
        with self._lock:
            rec = self._actors[actor_id]
            spec, res, strat = rec.spec, rec.resources, rec.scheduling_strategy
        try:
            worker_id, address = self.lease_worker(res, strategy=strat)
        except (TimeoutError, RuntimeError, exc.SchedulingError) as e:
            with self._cv:
                rec.state = "DEAD"
                rec.death_cause = f"scheduling failed: {e}"
                self._notify_all_locked()
            return
        client = self._clients.get(address)
        try:
            client.call("become_actor", actor_id, spec,
                        timeout=_worker_start_timeout())
        except Exception as e:  # noqa: BLE001 — creation failed on the worker
            self.return_worker(worker_id)
            with self._cv:
                rec.state = "DEAD"
                rec.death_cause = f"__init__ failed: {e}"
                self._notify_all_locked()
            return
        with self._cv:
            w = self._workers.get(worker_id)
            if w is not None:
                w.state = "ACTOR"
            rec.worker_id = worker_id
            rec.address = address
            rec.state = "ALIVE"
            self._notify_all_locked()
        self.publish("actor_state", {"actor_id": actor_id, "state": "ALIVE"})

    def get_actor_info(self, actor_id: Optional[str] = None,
                       name: Optional[str] = None,
                       namespace: str = "default",
                       wait_alive_timeout: float = 0.0) -> Dict[str, Any]:
        deadline = time.monotonic() + wait_alive_timeout
        with self._cv:
            while True:
                if actor_id is None:
                    aid = self._named_actors.get((namespace, name))
                    if aid is None:
                        raise ValueError(
                            f"no actor named {name!r} in namespace {namespace!r}")
                else:
                    aid = actor_id
                rec = self._actors.get(aid)
                if rec is None:
                    raise ValueError(f"unknown actor {aid}")
                if rec.state == "ALIVE" or rec.state == "DEAD" \
                        or time.monotonic() >= deadline:
                    return self._actor_info_locked(rec)
                self._cv.wait(min(0.1, max(0.0, deadline - time.monotonic())))

    @staticmethod
    def _actor_info_locked(rec: ActorRecord) -> Dict[str, Any]:
        return {"actor_id": rec.actor_id, "state": rec.state,
                "address": rec.address, "name": rec.name,
                "namespace": rec.namespace, "death_cause": rec.death_cause,
                "max_task_retries": rec.max_task_retries,
                "num_restarts": rec.num_restarts,
                "worker_id": rec.worker_id}

    def list_actors(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._actor_info_locked(r) for r in self._actors.values()]

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        with self._cv:
            rec = self._actors.get(actor_id)
            if rec is None:
                return
            if no_restart:
                rec.restarts_remaining = 0
            w = self._workers.get(rec.worker_id) if rec.worker_id else None
        if w is not None and w.proc is not None:
            try:
                w.proc.kill()
            except OSError:
                pass
        # the monitor loop observes the death and finalizes state

    def report_actor_exit(self, actor_id: str, cause: str) -> None:
        """Graceful exit (exit_actor): the actor's record dies now; the
        worker's lease and GPUs go back once the monitor sees its process
        exit."""
        with self._cv:
            rec = self._actors.get(actor_id)
            if rec is None:
                return
            rec.state = "DEAD"
            rec.death_cause = cause
            rec.restarts_remaining = 0
            self._notify_all_locked()
        self.publish("actor_state", {"actor_id": actor_id, "state": "DEAD"})

    # ------------------------------------------------------------------- KV

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True,
               namespace: str = "default") -> bool:
        with self._lock:
            ns = self._kv.setdefault(namespace, {})
            if not overwrite and key in ns:
                return False
            ns[key] = value
            return True

    def kv_get(self, key: bytes, namespace: str = "default") -> Optional[bytes]:
        with self._lock:
            return self._kv.get(namespace, {}).get(key)

    def kv_del(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            return self._kv.get(namespace, {}).pop(key, None) is not None

    def kv_keys(self, prefix: bytes = b"", namespace: str = "default") -> List[bytes]:
        with self._lock:
            return [k for k in self._kv.get(namespace, {}) if k.startswith(prefix)]

    # ---------------------------------------------------------------- pubsub

    def subscribe(self, channel: str, address: Tuple[str, int]) -> None:
        with self._lock:
            subs = self._subs.setdefault(channel, [])
            if tuple(address) not in subs:
                subs.append(tuple(address))

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, []))
        for addr in subs:
            try:
                self._clients.get(addr).notify("on_published", channel, message)
            except Exception:  # noqa: BLE001 — subscriber gone
                pass

    # ------------------------------------------------------------ task events

    def report_task_events(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._task_events.extend(events)
            if len(self._task_events) > 100_000:
                del self._task_events[:len(self._task_events) - 100_000]

    def get_task_events(self, limit: int = 10_000) -> List[Dict[str, Any]]:
        with self._lock:
            return self._task_events[-limit:]

    # ------------------------------------------------------------------ misc

    def ping(self) -> str:
        return "pong"

    # --------------------------------------------------------------- monitor

    def _monitor_loop(self) -> None:
        """Reap dead worker processes and restart their actors (reference
        gcs_actor_manager worker-death path). A worker's lease and GPUs
        return to the pool here, once its process has exited."""
        while not self._stopped:
            time.sleep(0.2)
            try:
                self._reap_dead_workers()
            except Exception:  # noqa: BLE001 — the monitor must not die
                traceback.print_exc()

    def _reap_dead_workers(self) -> None:
        dead: List[WorkerRecord] = []
        with self._cv:
            for w in self._workers.values():
                if w.proc is None or w.state == "DEAD" \
                        or w.proc.poll() is None:
                    continue
                w.state = "DEAD"
                self._release_resources(self._head, w.resources)
                w.resources = {}
                self._free_worker_gpus(w)
                dead.append(w)
                if w.address:
                    self._clients.invalidate(w.address)
            if dead:
                self._notify_all_locked()
        for w in dead:
            self._on_worker_death(w)

    def worker_death_cause(self, worker_id: str) -> Optional[str]:
        with self._lock:
            w = self._workers.get(worker_id)
            return w.death_cause if w is not None else None

    def _on_worker_death(self, w: WorkerRecord) -> None:
        restart: List[str] = []
        died: List[str] = []
        with self._cv:
            for rec in self._actors.values():
                if rec.worker_id == w.worker_id and rec.state == "ALIVE":
                    if rec.restarts_remaining != 0:
                        if rec.restarts_remaining > 0:
                            rec.restarts_remaining -= 1
                        rec.state = "RESTARTING"
                        rec.num_restarts += 1
                        restart.append(rec.actor_id)
                    else:
                        rec.state = "DEAD"
                        rec.death_cause = "worker process died"
                        died.append(rec.actor_id)
            self._notify_all_locked()
        for actor_id in restart:
            self.publish("actor_state",
                         {"actor_id": actor_id, "state": "RESTARTING"})
            threading.Thread(target=self._place_actor, args=(actor_id,),
                             daemon=True).start()
        for actor_id in died:
            self.publish("actor_state",
                         {"actor_id": actor_id, "state": "DEAD"})

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            workers = list(self._workers.values())
            self._notify_all_locked()
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                # RPC first: an rpc-handler thread can os._exit without
                # waiting for the MAIN thread to notice a signal flag
                if w.address:
                    try:
                        self._clients.get(tuple(w.address)).notify(
                            "shutdown_worker")
                    except Exception:  # noqa: BLE001 — already gone
                        pass
                try:
                    w.proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 3.0
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    try:
                        w.proc.kill()
                        # reap: an unreaped zombie still passes the
                        # sweeper's liveness probe, so its leaked
                        # segments would be skipped
                        w.proc.wait(2.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
        self._clients.close_all()
        from .worker_spawn import stop_fork_server

        stop_fork_server(self._session_dir)
        # workers that needed SIGKILL leaked their shm arena segments
        from .object_store import cleanup_leaked_segments

        cleanup_leaked_segments()


class Conductor:
    """Hosts a ConductorHandler on an RpcServer in the driver process."""

    def __init__(self, resources: Dict[str, float], session_dir: str,
                 host: str = "127.0.0.1", port: int = 0,
                 worker_env: Optional[Dict[str, str]] = None,
                 gpu_ids: Optional[Sequence[str]] = None):
        self.handler = ConductorHandler(resources, session_dir,
                                        worker_env=worker_env,
                                        gpu_ids=gpu_ids)
        self.server = RpcServer(self.handler, host=host, port=port,
                                max_workers=32, warn_slow=True)
        self.handler.address = self.server.address

    def start(self) -> "Conductor":
        from .worker_spawn import write_system_config

        write_system_config(self.handler._session_dir)
        self.server.start()
        self.handler._monitor.start()
        return self

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def stop(self) -> None:
        self.handler.stop()
        self.server.stop()
