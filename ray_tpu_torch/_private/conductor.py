"""Conductor: the cluster control plane.

The port's copy of the JAX package's conductor, an analog of the
reference's GCS server + raylet scheduling (src/ray/gcs/gcs_server/
gcs_server.h:78 and src/ray/raylet/scheduling/cluster_task_manager.cc)
merged into one authority that holds the resource view and grants
worker leases directly. Workers are leased to submitters, which then
push tasks *directly* worker-to-worker (the reference's direct task
transport, direct_task_transport.h:75).

Responsibilities:
- nodes: the head (its pool runs in this process's machine), node
  agents that joined (`register_node` with an address: their agent
  spawns their workers, and their heartbeats carry worker deaths and
  liveness) and accounting-only nodes (no address: the head's pool
  serves their leases);
- the worker pools: spawn, lease/return (reference worker_pool.h:156 /
  PopWorker :343), pack by default, SPREAD, node affinity, argument
  locality, parking the lease of a worker blocked in get()/wait();
- whole-GPU leases on any node: each node counts and names its own GPUs
  (the head the driver's visible list, an agent its own); a lease
  asking for n >= 1 whole GPUs ("GPU", or a placement group's
  "_pg_<id>_GPU") gets a worker spawned cold on that node with
  CUDA_VISIBLE_DEVICES naming n of that node's GPUs. A GPU returns to
  its node's pool only once its process is confirmed gone: reaped here
  on the head, reported by the agent's heartbeat on an agent node. Host
  workers see no GPU (CUDA_VISIBLE_DEVICES="");
- placement groups: atomic bundle reservation (PACK, SPREAD,
  STRICT_PACK, STRICT_SPREAD) exposed as `_pg_<id>_<res>` resources on
  the bundles' nodes;
- actors: creation (conductor-mediated like gcs_actor_manager.cc:255),
  named actors, kill, graceful exit, restart-on-death with max_restarts;
- internal KV + pubsub (gcs_kv_manager.cc); task events;
- resilience: the failure-domain tracker (quarantine), preemption
  reports with the `resilience` broadcast and host drains;
- the monitors: reap dead workers, expire silent agent nodes, the memory
  monitor's OOM kills, the head's log tailer (`worker_logs`);
- persistence: KV, named actors, placement groups, jobs and the actor
  workers' GPU bindings snapshot to the session directory; a conductor
  started on that directory restores them before it accepts a call;
- jobs: entrypoint drivers run as subprocesses with RTT_ADDRESS and
  RTT_JOB_ID; `shutdown_cluster` ends a standalone head and raises in a
  driver that hosts the conductor.

Left out (ROADMAP Queue 1): the L6 report and get methods (tracing
spans, the weight registry, the serving and training telemetry), each
with its subsystem. An RPC of those is absent: calling it raises.
"""
from __future__ import annotations

import collections
import os
import pickle
import re
import signal
import subprocess
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import exceptions as exc
from .ids import ActorID, NodeID, PlacementGroupID, WorkerID
from .rpc import ClientPool, RemoteError, RpcServer
from .worker_spawn import ForkedProc

# what job drivers find their cluster by (the JAX package's
# RAY_TPU_ADDRESS / RAY_TPU_JOB_ID)
ENV_ADDRESS = "RTT_ADDRESS"
ENV_JOB_ID = "RTT_JOB_ID"


def _worker_start_timeout() -> float:
    from .config import config

    return config.worker_start_timeout


_PG_GPU = re.compile(r"_pg_[^_]+_GPU")  # not a user's "_pg_<id>_A100_GPU"


def _gpus_needed(resources: Dict[str, float]) -> int:
    """Whole-GPU count a lease binds to the worker via
    CUDA_VISIBLE_DEVICES: the "GPU" key, or a placement group's
    "_pg_<id>_GPU". Fractional GPU shares only count resources — the
    binding is per process, so there is nothing to bind below one GPU."""
    for k, v in resources.items():
        if k == "GPU" or _PG_GPU.fullmatch(k):
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
    proc: Optional[Any] = None  # Popen-shaped handle of a local process
    resources: Dict[str, float] = field(default_factory=dict)  # held while leased
    # node whose resources the current lease took (an accounting node's
    # lease runs on the head's pool)
    lease_node_id: Optional[str] = None
    # lease resources parked while the worker blocks in get()/wait()
    # (reference: raylet releases blocked workers' resources)
    blocked_resources: Optional[Dict[str, float]] = None
    # the node pool's indices of the GPUs this process was bound to at
    # spawn; they stay bound for the process lifetime and return to the
    # pool only once it is confirmed gone
    gpu_ids: Optional[Tuple[int, ...]] = None
    # set on records rebuilt from a persistence snapshot: liveness is
    # unknown until both the worker and its node have registered again
    # (in either order), or restore_grace passes
    restored_at: Optional[float] = None
    # a restored record's held resources wait for its agent node to
    # re-register before they are charged
    uncharged: bool = False
    # why the worker died, when the runtime knows — submitters query this
    # to raise a typed error
    death_cause: Optional[str] = None
    # set before a deliberate kill: the death must not charge the
    # failure-domain tracker
    expected_death: bool = False
    # an agent's refusal to spawn this worker: fails the lease waiting
    # for it
    spawn_error: Optional[str] = None


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
    placement_group_id: Optional[str] = None
    # "DEFAULT" | "SPREAD" | ("NODE_AFFINITY", node_id, soft)
    scheduling_strategy: Any = "DEFAULT"


@dataclass
class PlacementGroupRecord:
    pg_id: str
    bundles: List[Dict[str, float]]
    strategy: str
    state: str = "CREATED"  # CREATED | REMOVED
    name: Optional[str] = None
    # node_id per bundle (parallel to `bundles`)
    assignments: List[str] = field(default_factory=list)


@dataclass
class NodeRecord:
    node_id: str
    total: Dict[str, float]
    available: Dict[str, float]
    address: Optional[Tuple[str, int]] = None  # node agent RPC (None = inline)
    alive: bool = True
    last_heartbeat: float = 0.0  # agent nodes only
    # the node's own id of each GPU it counts (what a worker's
    # CUDA_VISIBLE_DEVICES names), by pool index
    gpu_ids: List[str] = field(default_factory=list)
    # pool indices of GPUs not bound to any process
    free_gpus: List[int] = field(default_factory=list)

    @property
    def has_agent(self) -> bool:
        return self.address is not None


def _process_identity(proc) -> Optional[Tuple[int, int]]:
    """(pid, start time) of a local process handle, for the snapshot."""
    from .fork_server import proc_start_time

    if proc is None or proc.poll() is not None:
        return None
    try:
        return proc.pid, getattr(proc, "start_time", None) \
            or proc_start_time(proc.pid)
    except (OSError, ValueError, IndexError):
        return None


def _node_gpus(resources: Dict[str, float],
               gpu_ids: Optional[Sequence[str]]) -> List[str]:
    n_gpus = int(resources.get("GPU", 0))
    ids = [str(g) for g in (gpu_ids if gpu_ids is not None
                            else range(n_gpus))]
    if len(ids) < n_gpus:
        raise ValueError(f"{n_gpus} GPUs counted but only {len(ids)} GPU "
                         "ids given")
    return ids[:n_gpus]


class ConductorHandler:
    """RPC handler — every public method is remotely callable."""

    # block-by-design handlers (waiting IS their job): exempt from the
    # RPC server's slow-handler warning — see RpcServer warn_slow.
    _slow_ok_methods = frozenset({"lease_worker", "create_actor"})

    def __init__(self, resources: Dict[str, float], session_dir: str,
                 worker_env: Optional[Dict[str, str]] = None,
                 gpu_ids: Optional[Sequence[str]] = None,
                 standalone: bool = False):
        """`gpu_ids`: the head's id of each GPU it counts (what a
        worker's CUDA_VISIBLE_DEVICES names), by pool index.
        `standalone`: this process is a head of its own (`start
        --head`), which `shutdown_cluster` may end."""
        from ..resilience.domains import FailureDomainTracker
        from .config import config

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._nodes: Dict[str, NodeRecord] = {}
        self._workers: Dict[str, WorkerRecord] = {}
        self._actors: Dict[str, ActorRecord] = {}
        self._named_actors: Dict[Tuple[str, str], str] = {}  # (ns, name) -> id
        self._pgs: Dict[str, PlacementGroupRecord] = {}
        self._kv: Dict[str, Dict[bytes, bytes]] = {}
        self._subs: Dict[str, List[Tuple[str, int]]] = {}  # channel -> addrs
        self._task_events: List[Dict[str, Any]] = []
        self._session_dir = session_dir
        self._worker_env = dict(worker_env or {})
        self._standalone = standalone
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

        head_gpus = _node_gpus(resources, gpu_ids)
        head = NodeRecord(node_id=NodeID().hex(), total=dict(resources),
                          available=dict(resources), gpu_ids=head_gpus,
                          free_gpus=list(range(len(head_gpus))))
        self._nodes[head.node_id] = head
        self._head_node_id = head.node_id

        # Failure-domain quarantine + resilience event log: unexpected
        # worker deaths charge their host's decayed score; hosts over the
        # threshold are excluded from lease grants and bundle assignment.
        # The head is exempt from AUTO-quarantine (excluding the head's
        # pool on one host would deadlock every lease), though an
        # operator quarantine_node still pins it.
        self._fd_tracker = FailureDomainTracker(
            threshold=config.quarantine_threshold,
            half_life_s=config.quarantine_halflife_s,
            exempt=(head.node_id,))
        self._resilience_events: List[Dict[str, Any]] = []
        self._resilience_counters: Dict[str, int] = {}
        self._mem_monitor = None

        # Durable control-plane tables (reference: GCS Redis-persisted
        # tables, gcs_server.h:103-110 / gcs_table_storage.cc). Restored
        # here, before the RPC server accepts a call: a surviving worker
        # re-announcing itself must find its record.
        self._persist_path = os.path.join(session_dir, "conductor_state.pkl")
        self._dirty = False
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._restore_state()

        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="conductor-monitor", daemon=True)

    # ------------------------------------------------------------------ nodes

    def register_node(self, node_id: str, resources: Dict[str, float],
                      address: Optional[Tuple[str, int]] = None,
                      gpu_ids: Optional[Sequence[str]] = None) -> None:
        """`address` is the node's agent RPC endpoint, and `gpu_ids` the
        agent's id of each GPU it counts. address=None registers an
        accounting-only node served by the head's worker pool; it has
        no process that could own a card, so it may not count GPUs."""
        if address is None and resources.get("GPU", 0) > 0:
            raise ValueError(
                "an accounting-only node (address=None) cannot hold GPUs: "
                "its leases run in the head's pool; a node with GPUs joins "
                "through its agent (python -m ray_tpu_torch start "
                "--address)")
        node_gpus = _node_gpus(resources, gpu_ids)
        with self._cv:
            # GPUs still bound to a process of this node (its workers
            # outliving a conductor restart, or written off but not yet
            # reported gone) stay out of the pool
            bound = {g for w in self._workers.values()
                     if w.node_id == node_id for g in (w.gpu_ids or ())}
            node = NodeRecord(
                node_id=node_id, total=dict(resources),
                available=dict(resources),
                address=tuple(address) if address else None,
                last_heartbeat=time.monotonic(), gpu_ids=node_gpus,
                free_gpus=[g for g in range(len(node_gpus))
                           if g not in bound])
            self._nodes[node_id] = node
            self._reapply_pg_reservations(node_id)
            for w in self._workers.values():
                if w.uncharged and w.lease_node_id == node_id:
                    self._charge_locked(node, w.resources)
                    w.uncharged = False
                if w.node_id == node_id and w.pid is not None:
                    w.restored_at = None  # it re-registered first
            self._notify_all_locked()

    def _reapply_pg_reservations(self, node_id: str) -> None:
        """A (re-)registered node's record starts with full availability;
        re-reserve any live placement-group bundles assigned to it (the
        conductor-restart path — groups are persisted, nodes are not).
        Must hold the lock."""
        node = self._nodes[node_id]
        for pg in self._pgs.values():
            if pg.state != "CREATED":
                continue
            mine = [b for b, nid in zip(pg.bundles, pg.assignments or ())
                    if nid == node_id]
            if not mine:
                continue
            pk0 = f"_pg_{pg.pg_id}_"
            if any(k.startswith(pk0) for k in node.total):
                continue  # already applied (plain re-register)
            for b in mine:
                self._acquire_resources(node, b)
                for k, v in b.items():
                    pk = pk0 + k
                    node.total[pk] = node.total.get(pk, 0) + v
                    node.available[pk] = node.available.get(pk, 0) + v

    def node_heartbeat(self, node_id: str,
                       dead_worker_ids: Optional[List[str]] = None,
                       death_causes: Optional[Dict[str, str]] = None
                       ) -> bool:
        """Agent liveness + push-reported worker exits (the conductor
        cannot poll pids on remote hosts). A reported exit is the
        confirmation that returns the worker's GPUs to the node's pool.
        death_causes carries typed causes (the agent's memory monitor's
        OOM kills). Returns False for an unknown node (after a conductor
        restart): the agent then registers again."""
        dead_recs: List[WorkerRecord] = []
        with self._cv:
            n = self._nodes.get(node_id)
            if n is None:
                return False
            n.last_heartbeat = time.monotonic()
            n.alive = True
            for wid, cause in (death_causes or {}).items():
                w = self._workers.get(wid)
                if w is not None and w.death_cause is None:
                    w.death_cause = cause
            for wid in dead_worker_ids or []:
                w = self._workers.get(wid)
                if w is None:
                    continue
                if w.state != "DEAD":
                    self._mark_dead_locked(w)
                    dead_recs.append(w)
                self._free_worker_gpus(w)
            self._notify_all_locked()
        for w in dead_recs:
            self._on_worker_death(w)
        return True

    def deregister_node(self, node_id: str, force: bool = False) -> bool:
        """Remove a non-head node. Without force only an idle node may
        leave; with force (NodeAgent.stop — the host is going away
        regardless) its workers are declared dead, their leases freed,
        and their actors sent through the restart path."""
        dead: List[WorkerRecord] = []
        with self._cv:
            if node_id == self._head_node_id:
                return False
            n = self._nodes.get(node_id)
            if n is None:
                return False
            if not force and any(n.available.get(k, 0.0) < v
                                 for k, v in n.total.items()):
                return False  # leases still hold its resources
            for w in self._workers.values():
                if w.node_id == node_id and w.state != "DEAD":
                    w.expected_death = True  # host is leaving on purpose
                    self._mark_dead_locked(w)
                    dead.append(w)
            del self._nodes[node_id]
            self._notify_all_locked()
        for w in dead:
            self._on_worker_death(w)
        return True

    def _mark_dead_locked(self, w: WorkerRecord) -> None:
        """Write a worker off: its lease resources go back now; its GPUs
        only once its process is confirmed gone (_free_worker_gpus). A
        written-off worker that re-registers is told to exit. Must hold
        the lock."""
        w.state = "DEAD"
        self._release_resources(self._lease_release_node(w), w.resources)
        w.resources = {}
        w.blocked_resources = None
        w.uncharged = False
        if w.address:
            self._clients.invalidate(w.address)

    def _free_worker_gpus(self, w: WorkerRecord) -> None:
        """Return a gone worker's bound GPUs to its node's pool. Must
        hold the lock."""
        if not w.gpu_ids:
            return
        n = self._nodes.get(w.node_id)
        if n is not None:
            n.free_gpus.extend(g for g in w.gpu_ids if g not in n.free_gpus)
        w.gpu_ids = None

    def _reclaim_gpus_after_exit(self, w: WorkerRecord) -> None:
        """End `w` and return its GPUs to the pool only once its process
        is confirmed gone: a successor bound to the same GPUs while the
        old process's CUDA context still holds them would start on a
        card with its memory taken. A local process is terminated and
        reaped here; a worker of an agent node is told to shut down, and
        its agent's heartbeat report frees the GPUs."""
        if w.proc is None:
            self._notify_shutdown([w])
            return

        def confirmed_gone() -> bool:
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

    def _notify_shutdown(self, workers: Sequence[WorkerRecord]) -> None:
        """Tell written-off workers to exit now (their next re-register
        would tell them too). Call without the lock."""
        for w in workers:
            if not w.address:
                continue
            try:
                self._clients.get(tuple(w.address)).notify("shutdown_worker")
            except Exception:  # noqa: BLE001 — already gone
                pass

    def cluster_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {}
            for n in self._nodes.values():
                if not n.alive:
                    continue
                for k, v in n.total.items():
                    out[k] = out.get(k, 0) + v
            return out

    def available_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {}
            for n in self._nodes.values():
                if not n.alive:
                    continue
                for k, v in n.available.items():
                    out[k] = out.get(k, 0) + v
            return out

    def nodes(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"node_id": n.node_id, "alive": n.alive,
                     "total": dict(n.total), "available": dict(n.available),
                     "head": n.node_id == self._head_node_id,
                     "address": list(n.address) if n.address else None,
                     "gpu_ids": list(n.gpu_ids)}
                    for n in self._nodes.values()]

    # ---------------------------------------------------------------- workers

    def register_worker(self, worker_id: str, address: Tuple[str, int],
                        pid: int, node_id: Optional[str] = None,
                        gpu_ids: Optional[Tuple[int, ...]] = None) -> bool:
        """Returns False to tell the worker to shut itself down: the
        conductor does not know it (a restarted conductor keeps only its
        actors' workers), already wrote it off (its GPUs may be bound
        elsewhere), or it announces GPUs the conductor did not bind to
        it."""
        with self._cv:
            w = self._workers.get(worker_id)
            if w is None or w.state == "DEAD":
                return False
            if tuple(gpu_ids or ()) != tuple(w.gpu_ids or ()):
                return False
            w.address = tuple(address)
            w.pid = pid
            if w.node_id in self._nodes:
                # liveness confirmed; a restored worker whose agent has
                # not registered again keeps its grace until it does
                w.restored_at = None
            if w.state == "STARTING":
                w.state = "IDLE"
            self._notify_all_locked()
            return True

    def _spawn_worker(self, node: Optional[NodeRecord] = None,
                      gpus: Tuple[int, ...] = ()) -> WorkerRecord:
        """Start a worker on `node`'s pool (reference: WorkerPool PopWorker
        spawn path, worker_pool.h:343): the head spawns locally, an agent
        node by an RPC to its agent. A GPU worker is spawned cold with
        CUDA_VISIBLE_DEVICES naming its GPUs by the node's ids. Caller
        holds self._lock — the lease loop cv-waits for the new worker to
        register back."""
        from .worker_spawn import ENV_GPU_INDICES, spawn_worker_process

        node = node or self._nodes[self._head_node_id]
        worker_id = WorkerID().hex()
        w = WorkerRecord(worker_id=worker_id, node_id=node.node_id,
                         gpu_ids=tuple(gpus) or None)
        self._workers[worker_id] = w
        if node.has_agent:
            agent_addr, short = node.address, node.node_id[:12]

            def ask_agent():
                try:
                    self._clients.get(agent_addr).call(
                        "spawn_worker", worker_id, list(gpus) or None,
                        timeout=30.0)
                except Exception as e:  # noqa: BLE001 — fails the lease
                    with self._cv:
                        w.spawn_error = (f"node {short} failed to spawn a "
                                         f"worker: {e}")
                        if w.state != "DEAD":
                            w.state = "DEAD"
                        if isinstance(e, RemoteError):
                            # the agent refused: no process holds the GPUs
                            self._free_worker_gpus(w)
                        self._notify_all_locked()

            # RPC outside the conductor lock; the lease loop cv-waits for
            # the worker to register back.
            threading.Thread(target=ask_agent, daemon=True).start()
            return w
        env_extra = None
        if gpus:
            env_extra = {
                "CUDA_VISIBLE_DEVICES": ",".join(node.gpu_ids[g]
                                                 for g in gpus),
                ENV_GPU_INDICES: ",".join(str(g) for g in gpus)}
        w.proc = spawn_worker_process(
            worker_id, self.address, self._session_dir,
            worker_env=self._worker_env, env_extra=env_extra,
            node_id=node.node_id, cold=bool(gpus))
        return w

    @staticmethod
    def _acquire_resources(node: NodeRecord, req: Dict[str, float]) -> bool:
        for k, v in req.items():
            if k.startswith("_pg_") and k not in node.available:
                # the bundle's pool lives elsewhere: even a ZERO-resource
                # group lease (0-CPU actors) must land on the bundle's node
                return False
            if node.available.get(k, 0.0) + 1e-9 < v:
                return False
        for k, v in req.items():
            node.available[k] = node.available.get(k, 0.0) - v
        return True

    @staticmethod
    def _charge_locked(node: NodeRecord, req: Dict[str, float]) -> None:
        """Take `req` whatever is available (a restored lease)."""
        for k, v in req.items():
            node.available[k] = node.available.get(k, 0.0) - v

    @staticmethod
    def _release_resources(node: Optional[NodeRecord],
                           req: Dict[str, float]) -> None:
        if node is None:
            return
        for k, v in req.items():
            node.available[k] = node.available.get(k, 0.0) + v

    def lease_worker(self, resources: Dict[str, float],
                     placement_group_id: Optional[str] = None,
                     timeout: Optional[float] = None,
                     strategy: Any = "DEFAULT",
                     arg_locations=None) -> Tuple[str, Tuple[str, int]]:
        """Grant an idle worker (spawning if below capacity), holding
        `resources` against the node until return_worker. strategy
        DEFAULT packs (head-first, biased toward the node holding the
        most argument bytes — reference lease_policy.cc); SPREAD prefers
        the emptiest node; ("NODE_AFFINITY", node_id, soft) pins
        (reference node_affinity_scheduling_policy.cc): a hard pin to a
        dead, unknown or too small node raises SchedulingError. Inside a
        placement group the resources come out of its bundles' pools.

        `arg_locations`: [(holder_address, nbytes), ...] locality hints
        from the submitter; addresses not belonging to a registered
        worker (e.g. a driver) are ignored."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else _worker_start_timeout())
        resources = dict(resources or {})
        resources.setdefault("CPU", 1.0)
        if placement_group_id is not None:
            resources = {f"_pg_{placement_group_id}_{k}": v
                         for k, v in resources.items()}
        affinity = None
        if isinstance(strategy, (tuple, list)) and strategy \
                and strategy[0] == "NODE_AFFINITY":
            affinity = (str(strategy[1]), bool(strategy[2]))
        with self._cv:
            self._waiting_leases += 1
            my_cv = threading.Condition(self._lock)
            self._lease_waiter_cvs.append(my_cv)
            try:
                return self._lease_wait_locked(resources, deadline, strategy,
                                               arg_locations, affinity, my_cv)
            finally:
                self._waiting_leases -= 1
                try:
                    self._lease_waiter_cvs.remove(my_cv)
                except ValueError:
                    pass

    def _lease_release_node(self, w: WorkerRecord) -> Optional[NodeRecord]:
        """The node to credit a worker's held resources back to, or None
        when the node was deregistered mid-lease (its resources died with
        it)."""
        return self._nodes.get(w.lease_node_id or w.node_id) \
            or self._nodes.get(w.node_id)

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
        groups, spawn waits) plus one parked lease waiter. Must hold
        self._lock."""
        self._cv.notify_all()
        self._wake_lease_waiter_locked()

    def _lease_wait_locked(self, resources, deadline, strategy,
                           arg_locations, affinity, my_cv):
        while True:
            if self._stopped:
                raise RuntimeError("conductor stopped")
            head = self._nodes[self._head_node_id]
            nodes = [head] + [n for nid, n in self._nodes.items()
                              if nid != self._head_node_id and n.alive]
            pinned = None
            if affinity is not None:
                pinned = self._affinity_nodes_locked(affinity, resources)
            if pinned is not None:
                nodes = pinned
            else:
                # quarantine + preemption drain: a host that keeps
                # killing gangs, or one about to be reclaimed, gets no
                # new lease. When EVERY node is excluded the filter
                # yields — a degraded grant beats a deadlock. An explicit
                # NODE_AFFINITY pin beats quarantine.
                kept = [n for n in nodes
                        if not self._fd_tracker.is_excluded(n.node_id)]
                if kept:
                    nodes = kept
                if strategy == "SPREAD":
                    # emptiest node first (reference SPREAD policy,
                    # spread_scheduling_policy.cc)
                    def busy(n: NodeRecord) -> int:
                        return sum(1 for w in self._workers.values()
                                   if w.state in ("BUSY", "ACTOR")
                                   and (w.lease_node_id or w.node_id)
                                   == n.node_id)

                    nodes.sort(key=busy)
                elif arg_locations:
                    # data locality: stable-sort candidates by argument
                    # bytes resident on each node, most first (reference
                    # core_worker/lease_policy.cc)
                    score = self._locality_scores_locked(arg_locations)
                    if score:
                        nodes.sort(key=lambda n: -score.get(n.node_id, 0.0))
            acquired = next((n for n in nodes
                             if self._acquire_resources(n, resources)), None)
            if acquired is not None:
                try:
                    w = self._take_idle_or_spawn(deadline, acquired,
                                                 _gpus_needed(resources))
                except BaseException:
                    self._release_resources(acquired, resources)
                    raise
                if w is not None:
                    w.state = "BUSY"
                    w.resources = resources
                    w.lease_node_id = acquired.node_id
                    # grant cascade: capacity may remain (coalesced
                    # frees) — hand the baton to the next waiter
                    self._wake_lease_waiter_locked(skip=my_cv)
                    return w.worker_id, w.address
                self._release_resources(acquired, resources)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no worker available for {resources} within timeout; "
                    f"available={self.available_resources()}")
            my_cv.wait(min(remaining, 0.1))

    def _affinity_nodes_locked(self, affinity, resources):
        """Candidates under ("NODE_AFFINITY", node_id, soft): [target]
        while the node is alive and can ever fit the request (merely
        busy waits); soft degrades to None (the default order); hard
        raises SchedulingError — failing the task beats waiting
        forever."""
        node_id, soft = affinity
        target = self._nodes.get(node_id)
        feasible = target is not None and target.alive and all(
            target.total.get(k, 0.0) + 1e-9 >= v
            for k, v in resources.items() if not k.startswith("_pg_"))
        if feasible:
            # _pg_ keys exist only on the node(s) holding the
            # reservation: a pin elsewhere can never succeed
            feasible = all(k in target.available for k in resources
                           if k.startswith("_pg_"))
        if feasible:
            return [target]
        if soft:
            return None
        raise exc.SchedulingError(
            f"NodeAffinity(node_id={node_id!r}, soft=False) cannot be "
            "satisfied: node is "
            + ("dead or unknown" if target is None or not target.alive
               else f"too small for {resources}"))

    def _locality_scores_locked(self, arg_locations) -> Dict[str, float]:
        """node_id -> argument bytes held there, from (address, nbytes)
        hints. Unknown addresses (drivers, departed workers) score 0."""
        addr_to_node = {tuple(w.address): (w.lease_node_id or w.node_id)
                        for w in self._workers.values()
                        if w.address is not None}
        score: Dict[str, float] = {}
        for addr, nbytes in arg_locations:
            nid = addr_to_node.get(tuple(addr))
            if nid is not None:
                score[nid] = score.get(nid, 0.0) + max(float(nbytes), 1.0)
        return score

    def _take_idle_or_spawn(self, deadline: float, node: NodeRecord,
                            n_gpus: int = 0) -> Optional[WorkerRecord]:
        """Must hold lock. Returns a registered IDLE worker of the pool
        serving `node` (its own for an agent node, the head's for the
        head and accounting nodes) bound to exactly `n_gpus` of that
        pool's GPUs, spawning one if needed, or None by the deadline.
        GPU workers are reused only for leases of the same GPU count;
        idle GPU workers of another count are torn down to reclaim their
        GPUs when the pool runs dry. A spawn the agent refused raises
        SchedulingError: the lease fails, it never falls back to another
        kind of worker."""
        pool = node if node.has_agent else self._nodes[self._head_node_id]
        pool_id = pool.node_id
        mine: List[WorkerRecord] = []

        def idle():
            for w in self._workers.values():
                if w.state == "IDLE" and w.node_id == pool_id and \
                        len(w.gpu_ids or ()) == n_gpus:
                    return w
            return None

        def check_spawns():
            for w in mine:
                if w.spawn_error:
                    raise exc.SchedulingError(w.spawn_error)
            if not pool.alive or pool_id not in self._nodes:
                raise exc.SchedulingError(
                    f"node {pool_id[:12]} died while a lease waited for "
                    "its worker")

        def try_spawn_gpu_worker() -> bool:
            if len(pool.free_gpus) < n_gpus:
                # Reclaim GPUs bound to idle workers of other counts;
                # they return to the pool only once the old process has
                # exited, and the reclaim's notify retries the spawn.
                prospective = len(pool.free_gpus) + sum(
                    len(w.gpu_ids or ()) for w in self._workers.values()
                    if w.state == "DEAD" and w.node_id == pool_id
                    and w.gpu_ids)
                for w in list(self._workers.values()):
                    if prospective >= n_gpus:
                        break
                    if w.state == "IDLE" and w.node_id == pool_id and \
                            w.gpu_ids and len(w.gpu_ids) != n_gpus:
                        w.state = "DEAD"
                        w.expected_death = True
                        prospective += len(w.gpu_ids)
                        self._reclaim_gpus_after_exit(w)
            if len(pool.free_gpus) < n_gpus:
                return False
            gpus = tuple(sorted(pool.free_gpus)[:n_gpus])
            for g in gpus:
                pool.free_gpus.remove(g)
            mine.append(self._spawn_worker(pool, gpus))
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
                check_spawns()
                if not spawned:
                    spawned = try_spawn_gpu_worker()
                self._cv.wait(0.05)
            return None
        n_starting = sum(1 for w in self._workers.values()
                         if w.state == "STARTING"
                         and w.node_id == pool_id and not w.gpu_ids)
        # spawn enough for every lease currently waiting (parallel cold-start)
        want = max(1, self._waiting_leases)
        for _ in range(max(0, want - n_starting)):
            mine.append(self._spawn_worker(pool))
        while time.monotonic() < deadline and not self._stopped:
            w = idle()
            if w is not None:
                return w
            check_spawns()
            self._cv.wait(0.05)
        return None

    def return_worker(self, worker_id: str) -> None:
        with self._cv:
            w = self._workers.get(worker_id)
            if w is None or w.state == "DEAD":
                return
            self._release_resources(self._lease_release_node(w), w.resources)
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
            self._release_resources(self._lease_release_node(w),
                                    w.resources)
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
            node = self._lease_release_node(w)
            if node is not None:
                self._charge_locked(node, w.blocked_resources)
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
                     placement_group_id: Optional[str] = None,
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
                              placement_group_id=placement_group_id,
                              scheduling_strategy=scheduling_strategy)
            self._actors[actor_id] = rec
            self._dirty = True
            if name is not None:
                self._named_actors[(namespace, name)] = actor_id
        self._place_actor(actor_id)
        with self._lock:
            return self._actor_info_locked(self._actors[actor_id])

    def _place_actor(self, actor_id: str) -> None:
        """Lease a dedicated worker and instantiate the actor on it."""
        with self._lock:
            rec = self._actors[actor_id]
            spec, res, pg = rec.spec, rec.resources, rec.placement_group_id
            strat = rec.scheduling_strategy
        try:
            worker_id, address = self.lease_worker(
                res, placement_group_id=pg, strategy=strat)
        except (TimeoutError, RuntimeError, exc.SchedulingError) as e:
            with self._cv:
                rec.state = "DEAD"
                rec.death_cause = f"scheduling failed: {e}"
                self._dirty = True
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
                self._dirty = True
                self._notify_all_locked()
            return
        with self._cv:
            w = self._workers.get(worker_id)
            if w is not None:
                w.state = "ACTOR"
            rec.worker_id = worker_id
            rec.address = address
            rec.state = "ALIVE"
            self._dirty = True
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
                "worker_id": rec.worker_id,
                "placement_group_id": rec.placement_group_id}

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
            if w is not None and w.state != "DEAD" and \
                    not (w.proc is not None and w.proc.poll() is not None):
                # deliberate kill of a LIVE worker: not charged to the
                # failure-domain tracker
                w.expected_death = True
        if w is not None and w.proc is not None:
            try:
                w.proc.kill()
            except OSError:
                pass
        elif w is not None and w.address:
            # a worker of an agent node: its agent reports the exit
            self._notify_shutdown([w])
        # the monitor (or the agent's heartbeat) observes the death and
        # finalizes state

    def report_actor_exit(self, actor_id: str, cause: str) -> None:
        """Graceful exit (exit_actor): the actor's record dies now; the
        worker's lease and GPUs go back once its process's exit is
        seen."""
        with self._cv:
            rec = self._actors.get(actor_id)
            if rec is None:
                return
            rec.state = "DEAD"
            rec.death_cause = cause
            rec.restarts_remaining = 0
            self._dirty = True
            w = self._workers.get(rec.worker_id) if rec.worker_id else None
            if w is not None:
                w.expected_death = True
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
            self._dirty = True
            return True

    def kv_get(self, key: bytes, namespace: str = "default") -> Optional[bytes]:
        with self._lock:
            return self._kv.get(namespace, {}).get(key)

    def kv_del(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            self._dirty = True
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

    # ------------------------------------------------------- placement groups

    def _assign_bundles(self, bundles: List[Dict[str, float]],
                        strategy: str) -> List[str]:
        """Pick a node per bundle (reference bundle scheduling policies,
        scheduling/policy/bundle_scheduling_policy.h): PACK = first-fit
        onto the fewest nodes, SPREAD = round-robin with overflow,
        STRICT_PACK = one node or fail, STRICT_SPREAD = distinct nodes or
        fail. Must hold the lock. Raises ValueError when infeasible;
        mutates nothing."""
        order = [self._head_node_id] + sorted(
            nid for nid, n in self._nodes.items()
            if nid != self._head_node_id and n.alive)
        # quarantined/draining hosts are excluded from gang formation;
        # an all-excluded cluster falls back to the full list (liveness)
        kept = [nid for nid in order
                if not self._fd_tracker.is_excluded(nid)]
        if kept:
            order = kept
        avail = {nid: dict(self._nodes[nid].available) for nid in order}

        def fits(nid, b):
            return all(avail[nid].get(k, 0.0) >= v for k, v in b.items())

        def take(nid, b):
            for k, v in b.items():
                avail[nid][k] = avail[nid].get(k, 0.0) - v

        if strategy == "STRICT_PACK":
            for nid in order:
                trial = dict(avail[nid])
                ok = True
                for b in bundles:
                    if all(trial.get(k, 0.0) >= v for k, v in b.items()):
                        for k, v in b.items():
                            trial[k] = trial.get(k, 0.0) - v
                    else:
                        ok = False
                        break
                if ok:
                    return [nid] * len(bundles)
            raise ValueError(
                "STRICT_PACK infeasible: no single node fits all bundles")

        if strategy == "STRICT_SPREAD":
            assignment: List[str] = []
            used: set = set()
            for b in bundles:
                placed = next((nid for nid in order
                               if nid not in used and fits(nid, b)), None)
                if placed is None:
                    raise ValueError(
                        "STRICT_SPREAD infeasible: needs "
                        f"{len(bundles)} distinct nodes with capacity, "
                        f"have {len(order)}")
                take(placed, b)
                used.add(placed)
                assignment.append(placed)
            return assignment

        if strategy == "SPREAD":
            assignment = []
            start = 0
            for b in bundles:
                rotation = order[start:] + order[:start]
                placed = next((nid for nid in rotation if fits(nid, b)),
                              None)
                if placed is None:
                    raise ValueError(
                        f"SPREAD infeasible: no node fits bundle {b}")
                take(placed, b)
                assignment.append(placed)
                start = (order.index(placed) + 1) % len(order)
            return assignment

        # PACK: first-fit in fixed order keeps bundles on the fewest nodes
        assignment = []
        for b in bundles:
            placed = next((nid for nid in order if fits(nid, b)), None)
            if placed is None:
                raise ValueError(f"PACK infeasible: no node fits bundle {b}")
            take(placed, b)
            assignment.append(placed)
        return assignment

    def create_placement_group(self, bundles: List[Dict[str, float]],
                               strategy: str = "PACK",
                               name: Optional[str] = None) -> str:
        """Assign each bundle to a node per the strategy, then reserve
        atomically with rollback on partial failure (reference 2PC
        gcs_placement_group_scheduler.cc — one authority here, so the
        transaction is a lock-held reserve loop)."""
        bundles = [{k: float(v) for k, v in b.items()} for b in bundles]
        pg_id = PlacementGroupID().hex()
        with self._cv:
            assignment = self._assign_bundles(bundles, strategy)
            reserved: List[Tuple[NodeRecord, Dict[str, float]]] = []
            ok = True
            for b, nid in zip(bundles, assignment):
                node = self._nodes[nid]
                if not self._acquire_resources(node, b):
                    ok = False
                    break
                reserved.append((node, b))
            if not ok:  # raced with a concurrent reservation: roll back
                for node, b in reserved:
                    self._release_resources(node, b)
                raise ValueError(
                    f"placement group infeasible: bundles {bundles} "
                    "no longer fit their assigned nodes")
            # each bundle's pool as synthetic resources ON ITS NODE —
            # leases carrying the _pg_ prefix can then only be satisfied
            # where the bundle lives
            for b, nid in zip(bundles, assignment):
                node = self._nodes[nid]
                for k, v in b.items():
                    pk = f"_pg_{pg_id}_{k}"
                    node.total[pk] = node.total.get(pk, 0) + v
                    node.available[pk] = node.available.get(pk, 0) + v
            self._pgs[pg_id] = PlacementGroupRecord(
                pg_id=pg_id, bundles=bundles, strategy=strategy, name=name,
                assignments=assignment)
            self._dirty = True
            self._notify_all_locked()
        return pg_id

    def placement_group_ready(self, pg_id: str) -> bool:
        with self._lock:
            pg = self._pgs.get(pg_id)
            return pg is not None and pg.state == "CREATED"

    def remove_placement_group(self, pg_id: str) -> None:
        with self._cv:
            pg = self._pgs.pop(pg_id, None)
            if pg is None:
                return
            for b, nid in zip(pg.bundles, pg.assignments):
                node = self._nodes.get(nid)
                if node is None:  # node gone: its capacity went with it
                    continue
                for k in b:
                    pk = f"_pg_{pg_id}_{k}"
                    node.total.pop(pk, None)
                    node.available.pop(pk, None)
                self._release_resources(node, b)
            self._dirty = True
            self._notify_all_locked()

    def list_placement_groups(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"pg_id": p.pg_id, "bundles": p.bundles,
                     "strategy": p.strategy, "state": p.state,
                     "name": p.name, "assignments": list(p.assignments)}
                    for p in self._pgs.values()]

    # ------------------------------------------------------------ task events

    def report_task_events(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._task_events.extend(events)
            if len(self._task_events) > 100_000:
                del self._task_events[:len(self._task_events) - 100_000]

    def get_task_events(self, limit: int = 10_000) -> List[Dict[str, Any]]:
        with self._lock:
            return self._task_events[-limit:]

    # ------------------------------------------------------------ resilience
    # The conductor is the authority for preemption broadcast, failure-
    # domain quarantine and the resilience event log. The JAX package
    # also counts each event in Prometheus; the port's metrics side waits
    # for ROADMAP Queue 1 item 3, and get_resilience_status() carries the
    # same counters. The trainers' event sink (report_resilience_event)
    # and its time to recovery come with the trainer's workers mode
    # (item 3).

    _RESILIENCE_EVENTS_KEPT = 10_000

    def _resilience_record_locked(self, event: Dict[str, Any]) -> None:
        """Append an event + bump its kind counter. Must hold the lock."""
        event.setdefault("ts", time.time())
        self._resilience_events.append(event)
        if len(self._resilience_events) > self._RESILIENCE_EVENTS_KEPT:
            del self._resilience_events[
                :len(self._resilience_events)
                - self._RESILIENCE_EVENTS_KEPT]
        kind = str(event.get("kind", "other"))
        self._resilience_counters[kind] = \
            self._resilience_counters.get(kind, 0) + 1

    def _record_failure(self, node_id: str, kind: str, detail: str = "",
                        worker_id: Optional[str] = None) -> None:
        """Charge `node_id`'s failure domain; emits a quarantine event
        on the not-quarantined -> quarantined transition."""
        was = self._fd_tracker.is_quarantined(node_id)
        score = self._fd_tracker.record(node_id, kind, detail=detail)
        with self._lock:
            self._resilience_record_locked(
                {"kind": kind, "node_id": node_id, "detail": detail,
                 "worker_id": worker_id, "score": round(score, 4)})
            if not was and self._fd_tracker.is_quarantined(node_id):
                self._resilience_record_locked(
                    {"kind": "quarantine", "node_id": node_id,
                     "detail": f"score {score:.2f} >= threshold "
                               f"{self._fd_tracker.threshold:g}"})

    def report_preemption(self, node_id: Optional[str] = None,
                          worker_id: Optional[str] = None,
                          grace_s: Optional[float] = None,
                          reason: str = "maintenance") -> Dict[str, Any]:
        """A host announced it is going away (maintenance event, spot
        reclaim, SIGTERM). Drains the host — no new leases or bundles
        land on it for the grace window — and broadcasts "checkpoint
        now, grace N seconds" on the `resilience` pubsub channel."""
        from .config import config

        grace = config.preempt_grace_s if grace_s is None else \
            float(grace_s)
        with self._cv:
            if node_id is None and worker_id is not None:
                w = self._workers.get(worker_id)
                if w is not None:
                    node_id = w.lease_node_id or w.node_id
            if node_id is None:
                node_id = self._head_node_id
            self._fd_tracker.begin_drain(
                node_id, time.monotonic() + grace, reason)
            event = {"kind": "preemption", "ts": time.time(),
                     "node_id": node_id, "grace_s": grace,
                     "deadline": time.time() + grace, "reason": reason}
            self._resilience_record_locked(event)
            self._notify_all_locked()
        self.publish("resilience", event)
        return event

    def quarantine_node(self, node_id: str, reason: str = "manual") -> None:
        """Operator pin: exclude a node until clear_quarantine."""
        self._fd_tracker.quarantine(node_id, reason)
        with self._cv:
            self._resilience_record_locked(
                {"kind": "quarantine", "node_id": node_id,
                 "detail": reason, "manual": True})
            self._notify_all_locked()

    def clear_quarantine(self, node_id: str) -> bool:
        cleared = self._fd_tracker.clear(node_id)
        with self._cv:
            if cleared:
                self._resilience_record_locked(
                    {"kind": "quarantine_cleared", "node_id": node_id})
            self._notify_all_locked()
        return cleared

    def get_resilience_status(self) -> Dict[str, Any]:
        """Per-domain scores + quarantine/drain flags, excluded hosts,
        counters, recent events."""
        status = self._fd_tracker.status()
        with self._lock:
            return {
                "domains": status["domains"],
                "threshold": status["threshold"],
                "half_life_s": status["half_life_s"],
                "excluded": self._fd_tracker.excluded(),
                "head_node_id": self._head_node_id,
                "counters": dict(self._resilience_counters),
                "recent_events": self._resilience_events[-50:],
            }

    def get_resilience_events(self, limit: int = 10_000
                              ) -> List[Dict[str, Any]]:
        """Raw event log, oldest first."""
        with self._lock:
            return self._resilience_events[-limit:]

    def schedulable_resources(self) -> Dict[str, float]:
        """available_resources minus quarantined/draining hosts — what a
        gang re-form can actually get."""
        with self._lock:
            nodes = [(n.node_id, dict(n.available))
                     for n in self._nodes.values() if n.alive]
        out: Dict[str, float] = {}
        for node_id, available in nodes:
            if self._fd_tracker.is_excluded(node_id):
                continue
            for k, v in available.items():
                out[k] = out.get(k, 0) + v
        return out

    # ------------------------------------------------------------------ jobs
    # Reference: GcsJobManager + dashboard/modules/job JobManager —
    # entrypoint drivers run as head-node subprocesses with RTT_ADDRESS
    # and RTT_JOB_ID in the head's environment, logs captured per job.

    def submit_job(self, entrypoint: str,
                   env: Optional[Dict[str, str]] = None,
                   submission_id: Optional[str] = None,
                   working_dir: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        import uuid as _uuid

        job_id = submission_id or f"job_{_uuid.uuid4().hex[:12]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(
                    f"job submission id {job_id!r} already exists "
                    "(reference JobManager rejects duplicates)")
        logs = os.path.join(self._session_dir, "logs")
        os.makedirs(logs, exist_ok=True)
        log_path = os.path.join(logs, f"{job_id}.log")
        host, port = self.address
        penv = dict(os.environ)
        penv.update(env or {})
        penv[ENV_ADDRESS] = f"{host}:{port}"
        penv[ENV_JOB_ID] = job_id
        with open(log_path, "ab") as log_f:
            proc = subprocess.Popen(
                entrypoint, shell=True, env=penv,
                cwd=working_dir or os.getcwd(),
                stdout=log_f, stderr=subprocess.STDOUT,
                start_new_session=True)
        with self._lock:
            self._jobs[job_id] = {
                "job_id": job_id, "entrypoint": entrypoint,
                "start_time": time.time(), "end_time": None,
                "log_path": log_path, "proc": proc, "stopped": False,
                "metadata": dict(metadata or {})}
            self._dirty = True
        return job_id

    def _job_status_locked(self, rec: Dict[str, Any]) -> str:
        proc = rec["proc"]
        if proc is None:  # restored after a conductor restart
            return rec.get("status", "FAILED")
        code = proc.poll()
        if code is None:
            return "RUNNING"
        if rec["end_time"] is None:
            rec["end_time"] = time.time()
            self._dirty = True  # terminal status reached; persist it
        if rec["stopped"]:
            return "STOPPED"
        return "SUCCEEDED" if code == 0 else "FAILED"

    def _job_info_locked(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in dict(
            rec, status=self._job_status_locked(rec)).items()
            if k != "proc"}

    def get_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._jobs.get(job_id)
            return None if rec is None else self._job_info_locked(rec)

    def list_jobs(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._job_info_locked(r) for r in self._jobs.values()]

    def stop_job(self, job_id: str) -> bool:
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None or rec["proc"] is None \
                    or rec["proc"].poll() is not None:
                return False
            rec["stopped"] = True
            proc = rec["proc"]
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (OSError, ProcessLookupError):
            proc.terminate()
        return True

    def get_job_logs(self, job_id: str, tail_bytes: int = 1 << 20) -> str:
        with self._lock:
            rec = self._jobs.get(job_id)
        if rec is None:
            raise KeyError(job_id)
        try:
            with open(rec["log_path"], "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                return f.read().decode("utf-8", "replace")
        except FileNotFoundError:
            return ""

    def shutdown_cluster(self) -> bool:
        """Remote stop (`python -m ray_tpu_torch stop`): a standalone
        head stops the cluster shortly after replying and exits. A
        conductor hosted by a driver refuses: ending the process would
        end the user's program (its `shutdown()` stops the cluster)."""
        if not self._standalone:
            raise RuntimeError(
                "shutdown_cluster would end the driver process that hosts "
                "this conductor; call ray_tpu_torch.shutdown() there")

        def later():
            time.sleep(0.2)
            try:
                self.stop()
            finally:
                os._exit(0)

        threading.Thread(target=later, daemon=True).start()
        return True

    # ------------------------------------------------------------------ misc

    def ping(self) -> str:
        return "pong"

    def session_info(self) -> Dict[str, Any]:
        """What a joining agent or driver needs: the session directory,
        the head's node id and machine, and the head's resolved flag
        table (an agent installs it, and its workers get it through the
        spawn)."""
        from .config import config
        from .worker import machine_id

        return {"session_dir": self._session_dir,
                "head_node_id": self._head_node_id,
                "machine": machine_id(),
                "system_config": config.snapshot()}

    # ----------------------------------------------------------- persistence

    def _flush_state(self) -> None:
        """Write the durable tables to disk (atomic rename). Called by the
        monitor when dirty and on stop — mutations only mark dirty, so the
        hot path never pays the disk write."""
        with self._lock:
            if not self._dirty:
                return
            self._dirty = False
            jobs = {}
            for jid, r in self._jobs.items():
                meta = {k: v for k, v in r.items() if k != "proc"}
                meta["status"] = self._job_status_locked(r)
                jobs[jid] = meta
            # the actors' workers: where each runs and the GPUs it holds,
            # so a restarted conductor keeps those GPUs out of its pools
            workers = {
                w.worker_id: {"node_id": w.node_id,
                              "lease_node_id": w.lease_node_id,
                              "gpu_ids": w.gpu_ids,
                              "process": _process_identity(w.proc)}
                for w in self._workers.values()
                if w.state == "ACTOR"}
            blob = pickle.dumps({
                "kv": {ns: dict(d) for ns, d in self._kv.items()},
                "named_actors": dict(self._named_actors),
                "actors": list(self._actors.values()),
                "pgs": list(self._pgs.values()),
                "jobs": jobs,
                "workers": workers,
                # a restarted conductor mints a fresh head node id:
                # assignments pointing at THIS id are remapped
                "head_node_id": self._head_node_id,
            })
        tmp = self._persist_path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._persist_path)
        except OSError:
            with self._lock:
                self._dirty = True  # retry next monitor tick

    def _restore_state(self) -> None:
        """Load a prior snapshot from this session dir (conductor
        restart). Actor records come back with their worker addresses,
        so handles keep working against surviving worker processes;
        those workers' records are rebuilt provisionally (holding their
        leases and GPUs) and confirmed by their re-registration, or
        written off once restore_grace passes without one."""
        if not os.path.exists(self._persist_path):
            return
        try:
            with open(self._persist_path, "rb") as f:
                state = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError):
            return
        with self._lock:
            head = self._nodes[self._head_node_id]
            old_head = state.get("head_node_id")

            def remap(nid):
                return self._head_node_id if nid in (None, old_head) else nid

            self._kv = {ns: dict(d) for ns, d in state.get("kv", {}).items()}
            self._named_actors = dict(state.get("named_actors", {}))
            now = time.monotonic()
            # groups first: actors scheduled inside one hold its
            # `_pg_<id>_<k>` keys, which must exist to re-charge. Head
            # bundles re-reserve now; agent-node bundles when their node
            # registers again (_reapply_pg_reservations).
            for pg in state.get("pgs", []):
                if pg.state != "CREATED":
                    continue
                pg.assignments = [remap(nid) for nid in pg.assignments]
                for b, nid in zip(pg.bundles, pg.assignments):
                    if nid != self._head_node_id:
                        continue
                    self._acquire_resources(head, b)
                    for k, v in b.items():
                        pk = f"_pg_{pg.pg_id}_{k}"
                        head.total[pk] = head.total.get(pk, 0) + v
                        head.available[pk] = head.available.get(pk, 0) + v
                self._pgs[pg.pg_id] = pg
            saved_workers = state.get("workers", {})
            for rec in state.get("actors", []):
                self._actors[rec.actor_id] = rec
                if rec.state not in ("ALIVE", "RESTARTING") \
                        or not rec.worker_id:
                    continue
                saved = saved_workers.get(rec.worker_id, {})
                node_id = remap(saved.get("node_id"))
                lease_node = remap(saved.get("lease_node_id") or node_id)
                # mirror lease_worker: a group actor's lease holds the
                # bundle's prefixed keys, not general capacity
                if rec.placement_group_id:
                    held = {f"_pg_{rec.placement_group_id}_{k}": v
                            for k, v in rec.resources.items()}
                else:
                    held = dict(rec.resources)
                gpus = saved.get("gpu_ids")
                w = WorkerRecord(worker_id=rec.worker_id, node_id=node_id,
                                 address=rec.address, state="ACTOR",
                                 resources=held, lease_node_id=lease_node,
                                 gpu_ids=tuple(gpus) if gpus else None,
                                 restored_at=now)
                if node_id == self._head_node_id and saved.get("process"):
                    # a process of this machine: watched by pid and start
                    # time, so its exit frees its GPUs however it comes
                    w.proc = ForkedProc(*saved["process"])
                self._workers[w.worker_id] = w
                if lease_node == self._head_node_id:
                    self._charge_locked(head, held)
                else:
                    w.uncharged = True
                if node_id == self._head_node_id and w.gpu_ids:
                    head.free_gpus = [g for g in head.free_gpus
                                      if g not in w.gpu_ids]
            for jid, meta in state.get("jobs", {}).items():
                meta = dict(meta, proc=None)
                if meta.get("status") == "RUNNING":
                    # the job driver was orphaned by the crash; it can no
                    # longer be supervised
                    meta["status"] = "FAILED"
                    meta["end_time"] = meta.get("end_time") or time.time()
                self._jobs[jid] = meta

    # --------------------------------------------------------------- monitor

    def _monitor_loop(self) -> None:
        """Flush the snapshot, run the memory monitor, expire silent
        agent nodes, reap dead workers and restart their actors
        (reference gcs_health_check_manager.cc + gcs_actor_manager
        worker-death path)."""
        from .config import config

        last_mem_check = 0.0
        while not self._stopped:
            time.sleep(0.2)
            try:
                self._flush_state()
                refresh_ms = config.memory_monitor_refresh_ms
                if refresh_ms > 0 and time.monotonic() - last_mem_check \
                        >= refresh_ms / 1000.0:
                    last_mem_check = time.monotonic()
                    self._maybe_oom_kill()
                self._reap_dead_workers()
            except Exception:  # noqa: BLE001 — the monitor must not die
                traceback.print_exc()

    def _reap_dead_workers(self) -> None:
        from .config import config

        died: List[WorkerRecord] = []
        dead: List[WorkerRecord] = []  # written off earlier, now gone
        written_off: List[WorkerRecord] = []
        with self._cv:
            now = time.monotonic()
            # heartbeat-expired agent nodes first: their workers are
            # written off in the same tick
            for n in self._nodes.values():
                if n.has_agent and n.alive \
                        and now - n.last_heartbeat > config.node_timeout:
                    n.alive = False
            for w in self._workers.values():
                # the process is known to have exited
                gone = w.proc is not None and w.proc.poll() is not None
                if w.state == "DEAD":
                    if gone and w.gpu_ids:  # a written-off local worker
                        self._free_worker_gpus(w)
                        dead.append(w)
                    continue
                node = self._nodes.get(w.node_id)
                if gone:
                    alive = False
                elif w.restored_at is not None:
                    # presumed alive until the re-register window passes
                    alive = now - w.restored_at <= config.restore_grace
                elif w.proc is not None:
                    alive = True
                elif node is not None and node.has_agent:
                    # remote pid: its exit arrives by the agent's
                    # heartbeat; a dead node writes its workers off
                    alive = node.alive
                else:
                    alive = node is not None
                if alive:
                    continue
                self._mark_dead_locked(w)
                if gone:
                    self._free_worker_gpus(w)
                else:
                    written_off.append(w)
                died.append(w)
            if died or dead:
                self._notify_all_locked()
        self._notify_shutdown(written_off)
        for w in died:
            self._on_worker_death(w)

    def _maybe_oom_kill(self) -> None:
        """Memory-monitor tick (reference memory_monitor.h:52 +
        worker_killing_policy.cc): above the threshold, SIGKILL the
        greediest worker of the head's machine — task workers before
        actors before idle — recording 'oom: ...' as its death cause so
        the submitter raises OutOfMemoryError instead of a bare crash.
        Agent nodes police themselves and report causes by heartbeat."""
        from .config import config
        from .memory_monitor import MemoryMonitor

        threshold = config.memory_usage_threshold
        mon = self._mem_monitor
        if mon is None or mon.threshold != threshold:
            mon = self._mem_monitor = MemoryMonitor(threshold)
        with self._lock:
            cands = [(w.worker_id, w.proc.pid, w.state)
                     for w in self._workers.values()
                     if w.proc is not None and w.state != "DEAD"
                     and w.proc.poll() is None]
        res = mon.kill_greediest(cands, "head")
        if res is None:
            return
        worker_id, cause = res
        with self._lock:
            rec = self._workers.get(worker_id)
            if rec is not None:
                rec.death_cause = cause  # submitters re-query after a
                # short grace, covering the kill→record window

    def worker_death_cause(self, worker_id: str) -> Optional[str]:
        with self._lock:
            w = self._workers.get(worker_id)
            return w.death_cause if w is not None else None

    def _on_worker_death(self, w: WorkerRecord) -> None:
        if not w.expected_death:
            # unexpected death (crash, OOM, host loss): charge the host's
            # failure domain — what eventually quarantines a flaky host
            self._record_failure(w.lease_node_id or w.node_id,
                                 "worker_death",
                                 detail=w.death_cause or "",
                                 worker_id=w.worker_id)
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
            self._dirty = True
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
            jobs = list(self._jobs.values())
            agents = [n.address for n in self._nodes.values()
                      if n.has_agent and n.alive]
            self._notify_all_locked()
        for addr in agents:
            try:
                self._clients.get(addr).call("stop_node", timeout=5.0)
            except Exception:  # noqa: BLE001 — agent already gone
                pass
        for rec in jobs:
            if rec["proc"] is not None and rec["proc"].poll() is None:
                try:
                    os.killpg(rec["proc"].pid, signal.SIGTERM)
                except (OSError, ProcessLookupError):
                    pass
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
        for rec in jobs:
            if rec["proc"] is not None:
                try:
                    rec["proc"].wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    try:
                        os.killpg(rec["proc"].pid, signal.SIGKILL)
                        rec["proc"].wait(2.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
        self._clients.close_all()
        self._flush_state()
        from .worker_spawn import stop_fork_server

        stop_fork_server(self._session_dir)
        # workers that needed SIGKILL leaked their shm arena segments
        from .object_store import cleanup_leaked_segments

        cleanup_leaked_segments()


class Conductor:
    """Hosts a ConductorHandler on an RpcServer, with the head's log
    tailer and, given a maintenance-event file, its preemption watcher.
    `standalone`: a head process of its own (`start --head`)."""

    def __init__(self, resources: Dict[str, float], session_dir: str,
                 host: str = "127.0.0.1", port: int = 0,
                 worker_env: Optional[Dict[str, str]] = None,
                 gpu_ids: Optional[Sequence[str]] = None,
                 standalone: bool = False,
                 maintenance_event: Optional[str] = None):
        self.handler = ConductorHandler(resources, session_dir,
                                        worker_env=worker_env,
                                        gpu_ids=gpu_ids,
                                        standalone=standalone)
        self.server = RpcServer(self.handler, host=host, port=port,
                                max_workers=32, warn_slow=True)
        self.handler.address = self.server.address
        self._maintenance_event = maintenance_event
        self._log_monitor = None
        self._preemption_watcher = None

    def start(self) -> "Conductor":
        from .log_monitor import LogMonitor
        from .worker_spawn import write_system_config

        write_system_config(self.handler._session_dir)
        self.server.start()
        self.handler._monitor.start()
        # the head's log tailer: worker prints ride the worker_logs
        # pubsub channel to subscribed drivers (reference log_monitor.py)
        h = self.handler
        self._log_monitor = LogMonitor(
            os.path.join(h._session_dir, "logs"),
            lambda batch: h.publish("worker_logs", batch),
            node_label="head").start()
        if self._maintenance_event:
            from ..resilience.preemption import PreemptionWatcher

            self._preemption_watcher = PreemptionWatcher(
                lambda ev: h.report_preemption(
                    node_id=h._head_node_id, grace_s=ev.grace_s,
                    reason=ev.reason),
                spec=self._maintenance_event).start()
        return self

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def stop(self) -> None:
        for part in (self._preemption_watcher, self._log_monitor):
            if part is not None:
                part.stop()
        self.handler.stop()
        self.server.stop()
