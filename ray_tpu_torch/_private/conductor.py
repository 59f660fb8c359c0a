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
- observability: tracing spans (capped at 100,000), each process's
  metric snapshot, the RPC server's per-method dispatch stats and the
  recent worker log lines (a ring of 2,000 off the `worker_logs`
  channel);
- resilience: the failure-domain tracker (quarantine), preemption
  reports with the `resilience` broadcast and host drains;
- the monitors: reap dead workers, expire silent agent nodes, the memory
  monitor's OOM kills, the head's log tailer (`worker_logs`);
- the weight fabric's version registry: producers send metadata-only
  fragments, a version commits when every host's fragment is in,
  keep-last-K GC and the reaping of torn publishes notify producers on
  the `weights` channel (with the object ids to free), and the weight
  event log;
- disaggregated serving, the global KV plane and serving fault
  tolerance: component snapshots and markers, and the KV plane's prefix
  directory (atomic commit, TTL reap, keep-last-K GC; not persisted);
- persistence: KV, named actors, placement groups, jobs, the actor
  workers' GPU bindings and the weight registry snapshot to the session
  directory; a conductor started on that directory restores them before
  it accepts a call;
- jobs: entrypoint drivers run as subprocesses with RTT_ADDRESS and
  RTT_JOB_ID; `shutdown_cluster` ends a standalone head and raises in a
  driver that hosts the conductor.

Left out (ROADMAP Queue 1): the report and get methods of the
subsystems not ported yet (the oracle's reads, the pending demand), each
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
        self._spans: List[Dict[str, Any]] = []  # tracing span table
        self._metrics: Dict[str, List[Dict[str, Any]]] = {}
        self._recent_logs: "collections.deque" = collections.deque(
            maxlen=2000)
        self._rpc_server: Optional[RpcServer] = None  # set by Conductor
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
        self._last_ttr_s: Optional[float] = None
        self._mem_monitor = None
        # the weight fabric's version registry (metadata only: chunks
        # live in their producers' stores)
        self._weights_committed: Dict[str, Dict[int, Dict[str, Any]]] = {}
        self._weights_pending: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._weight_events: List[Dict[str, Any]] = []
        # disaggregated serving and the global KV plane (serve/disagg.py,
        # serve/kvplane.py): component snapshots and instant markers, and
        # the prefix directory, (namespace, chain digest) -> holder and
        # chunk descriptor, metadata only. Not persisted, as in the JAX
        # package: a restart empties the directory and routing falls back
        # to the affinity hash.
        self._disagg_stats: Dict[str, Dict[str, Any]] = {}
        self._disagg_events: List[Dict[str, Any]] = []
        self._kvplane_stats: Dict[str, Dict[str, Any]] = {}
        self._kvplane_events: List[Dict[str, Any]] = []
        self._kvplane_dir: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._kvplane_dir_counters: Dict[str, int] = {
            k: 0 for k in ("publishes", "republishes", "lookups",
                           "directory_hits", "directory_misses",
                           "reaped", "gced", "unpublished")}
        self._servefault_stats: Dict[str, Dict[str, Any]] = {}
        # the engines' paged KV cache and speculation snapshots, the
        # adapter pools' and routers' LoRA snapshots, the request flight
        # recorder's store snapshots, and each one's instant markers; in
        # memory as in the JAX package
        self._kvcache_stats: Dict[str, Dict[str, Any]] = {}
        self._kvcache_events: List[Dict[str, Any]] = []
        self._lora_stats: Dict[str, Dict[str, Any]] = {}
        self._lora_events: List[Dict[str, Any]] = []
        self._requesttrace_stats: Dict[str, Dict[str, Any]] = {}
        self._requesttrace_events: List[Dict[str, Any]] = []
        # the HTTP front door (serve/gateway.py): replica snapshots and
        # the accept / first_byte / preempt / rate_limit / disconnect
        # markers; in memory as in the JAX package
        self._gateway_stats: Dict[str, Dict[str, Any]] = {}
        self._gateway_events: List[Dict[str, Any]] = []
        # the serving autoscaler (serve/autoscale.py) and the online
        # learning loop (online/): snapshots and instant markers, in
        # memory as in the JAX package
        self._autoscale_stats: Dict[str, Dict[str, Any]] = {}
        self._autoscale_events: List[Dict[str, Any]] = []
        self._online_stats: Dict[str, Dict[str, Any]] = {}
        self._online_events: List[Dict[str, Any]] = []
        # the flight recorder's step records, run_id -> {"steps": {step:
        # {rank: record}}, "updated": ts}, and the MPMD pipelines'
        # registry, channel mailbox (descriptors only: the payloads stay
        # in the senders' stores) and instant markers; in memory as in
        # the JAX package
        self._train_runs: Dict[str, Dict[str, Any]] = {}
        self._pipelines: Dict[str, Dict[str, Any]] = {}
        self._pipeline_mailbox: Dict[str, Dict[str, Any]] = {}
        self._pipeline_events: List[Dict[str, Any]] = []

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
        if channel == "worker_logs":
            # the ring the state API's log reads serve
            ts = time.time()
            with self._lock:
                for entry in (message if isinstance(message, list)
                              else ()):
                    self._recent_logs.append({**entry, "ts": ts})
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

    # --------------------------------------------------------- observability

    def report_spans(self, spans: List[Dict[str, Any]]) -> None:
        """Tracing spans flushed by workers and drivers (util/tracing.py
        drain), bounded as the task events are."""
        with self._lock:
            self._spans.extend(spans)
            if len(self._spans) > 100_000:
                del self._spans[:len(self._spans) - 100_000]

    def get_spans(self, limit: int = 10_000) -> List[Dict[str, Any]]:
        with self._lock:
            return self._spans[-limit:]

    def report_metrics(self, worker_id: str,
                       snapshot: List[Dict[str, Any]]) -> None:
        """A process's metric registry snapshot (util/metrics.py); the
        state API renders the latest of each as Prometheus text."""
        with self._lock:
            self._metrics[worker_id] = snapshot

    def get_metrics(self) -> Dict[str, List[Dict[str, Any]]]:
        with self._lock:
            return dict(self._metrics)

    def get_rpc_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-method dispatch latency of this conductor's RPC server —
        the control plane's instrumented_io_context analog (reference
        src/ray/common/asio/instrumented_io_context.h stats)."""
        srv = self._rpc_server
        return srv.handler_stats() if srv is not None else {}

    def get_recent_logs(self, limit: int = 500) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._recent_logs)[-limit:]

    # ------------------------------------------------------------ resilience
    # The conductor is the authority for preemption broadcast, failure-
    # domain quarantine and the resilience event log, with the trainers'
    # event sink (report_resilience_event: restarts, grace checkpoints,
    # gang peer deaths, elastic re-forms, recoveries with their time to
    # recovery, chaos injections). The JAX package also counts each
    # event in Prometheus; the port's metrics side waits for ROADMAP
    # Queue 1 item 3, and get_resilience_status() carries the same
    # counters.

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
        if kind == "recovery" and event.get("ttr_s") is not None:
            self._last_ttr_s = float(event["ttr_s"])

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

    def report_resilience_event(self, event: Dict[str, Any]) -> None:
        """Event sink for trainers, supervisors and chaos: restart,
        grace_checkpoint, gang_peer_death, elastic_reform, recovery (with
        its time to recovery `ttr_s`), chaos injections."""
        if not isinstance(event, dict):
            return
        with self._lock:
            self._resilience_record_locked(dict(event))

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
                "last_ttr_s": self._last_ttr_s,
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

    # ------------------------------------------------------ weight fabric
    # weights/: the conductor is the version registry. Producers
    # publish their LOCAL shards into their own object stores and send
    # only a metadata fragment here; the version commits atomically when
    # every host's fragment is in. Keep-last-K GC and partial-publish
    # reaping notify producers over the `weights` pubsub channel so they
    # can free the dropped chunks they own.

    _WEIGHT_EVENTS_KEPT = 10_000

    def _weight_event_locked(self, event: Dict[str, Any]) -> None:
        event.setdefault("ts", time.time())
        self._weight_events.append(event)
        if len(self._weight_events) > self._WEIGHT_EVENTS_KEPT:
            del self._weight_events[
                :len(self._weight_events) - self._WEIGHT_EVENTS_KEPT]

    def report_weight_event(self, event: Dict[str, Any]) -> None:
        """Client-side markers (fetch, swap) for the merged timeline —
        publish/gc/reap events are recorded by the registry itself."""
        if not isinstance(event, dict):
            return
        with self._lock:
            self._weight_event_locked(dict(event))

    def get_weight_events(self, limit: int = 10_000) -> List[Dict[str, Any]]:
        with self._lock:
            return self._weight_events[-limit:]

    def weights_publish_fragment(self, name: str, version: int, host: int,
                                 num_hosts: int, fragment: Dict[str, Any],
                                 run_id: str = "",
                                 step: Optional[int] = None
                                 ) -> Dict[str, Any]:
        """One host's share of a publish: per-leaf shard metadata (the
        chunk ObjectIDs live in that host's store). The version flips
        committed — and becomes fetchable — only when all `num_hosts`
        fragments are in; until then it is invisible to subscribers and
        a died-mid-publish producer leaves only a reapable pending
        entry, never a torn manifest."""
        version = int(version)
        publish_msg = None
        gc_msgs: List[Dict[str, Any]] = []
        with self._cv:
            by_ver = self._weights_committed.setdefault(name, {})
            if version in by_ver:
                return {"error": f"version {version} of {name!r} is "
                                 "already committed"}
            base_version = fragment.get("base_version")
            if base_version is not None \
                    and int(base_version) not in by_ver:
                # delta against a base this registry no longer holds
                # (GC'd between the publisher's probe and this call):
                # reject so the publisher's full fallback runs — an
                # inherit-from-nothing commit would be a torn manifest
                return {"error": f"delta base {base_version} of "
                                 f"{name!r} is gone"}
            key = (name, version)
            pend = self._weights_pending.get(key)
            if pend is not None and int(num_hosts) != pend["num_hosts"]:
                # a gang RESIZED between attempts (elastic re-form after
                # a crash that left this version partially published):
                # the stale pending entry can never complete under the
                # old num_hosts, and erroring here would crash-loop the
                # recovered gang until the TTL reaper ran — supersede
                # it, telling the old fragments' owners to free EXACTLY
                # those chunks (by object id: the new gang's in-flight
                # chunks share the version number and must survive)
                gc_msgs.append({
                    "kind": "reaped", "name": name,
                    "versions": [version],
                    "object_ids": self._weights_object_ids(
                        f["leaves"] for f in
                        pend["fragments"].values())})
                self._weight_event_locked(
                    {"kind": "reap", "name": name, "version": version,
                     "detail": f"superseded: num_hosts "
                               f"{pend['num_hosts']} -> {num_hosts}"})
                pend = None
            if pend is None:
                pend = self._weights_pending[key] = {
                    "fragments": {}, "num_hosts": int(num_hosts),
                    "run_id": run_id, "step": step,
                    "started": time.monotonic()}
            prev_frag = pend["fragments"].get(int(host))
            if prev_frag is not None:
                # fragment RESEND (publisher retry after an ambiguous
                # RPC timeout): the replaced fragment's chunks are
                # referenced by nothing from here on — reap-notice them
                # or the producer pins a full stale shard copy forever
                gc_msgs.append({
                    "kind": "reaped", "name": name,
                    "versions": [version],
                    "object_ids": self._weights_object_ids(
                        [prev_frag["leaves"]])})
            pend["fragments"][int(host)] = fragment
            self._dirty = True  # registry is a durable table: producers'
            # chunk refs depend on gc/reap notices that only a registry
            # remembering the version can ever send (conductor bounce)
            committed = len(pend["fragments"]) == pend["num_hosts"]
            error = None
            if committed:
                # delta commits inherit unchanged leaves from their base
                # manifests — every named base must still be here (a
                # fragment-time check passed, but another host's base
                # could have been GC'd while this publish was pending)
                gone = sorted({int(f["base_version"])
                               for f in pend["fragments"].values()
                               if f.get("base_version") is not None
                               and int(f["base_version"]) not in by_ver})
                if gone:
                    del self._weights_pending[key]
                    gc_msgs.append({
                        "kind": "reaped", "name": name,
                        "versions": [version],
                        "object_ids": self._weights_object_ids(
                            f["leaves"] for f in
                            pend["fragments"].values())})
                    self._weight_event_locked(
                        {"kind": "reap", "name": name,
                         "version": version,
                         "detail": f"delta base {gone} gone"})
                    error = (f"delta base {gone[0]} of {name!r} is "
                             "gone")
                else:
                    del self._weights_pending[key]
                    manifest = self._weights_commit_locked(name, version,
                                                           pend)
                    publish_msg = {"kind": "published", "name": name,
                                   "version": version, "step": step,
                                   "run_id": run_id,
                                   "total_bytes":
                                       manifest["total_bytes"]}
                    # EXTEND: a supersede notice queued above must still
                    # go out when the superseding fragment commits
                    # immediately
                    gc_msgs.extend(self._weights_gc_locked(name, None))
            self._notify_all_locked()
        if publish_msg is not None:
            self.publish("weights", publish_msg)
        for msg in gc_msgs:
            self.publish("weights", msg)
        if error is not None:
            return {"error": error}
        return {"committed": committed, "version": version}

    @staticmethod
    def _weights_object_ids(leaves_by_frag) -> List[str]:
        """Chunk object ids referenced by fragments or manifest leaves.
        gc/reap notices name EXPLICIT object ids so a publisher only
        ever frees the chunks the registry actually dropped — a
        version-scoped notice would also hit a NEW publish in flight
        under the same version number (gang resize supersede)."""
        out: List[str] = []
        for leaves in leaves_by_frag:
            for leaf in (leaves.values() if isinstance(leaves, dict)
                         else leaves):
                for sh in leaf.get("shards", ()):
                    out.append(sh["object_id"])
        return out

    @staticmethod
    def _weights_recency(manifest: Dict[str, Any]) -> Tuple[float, int]:
        """Ordering key for GC and 'latest': commit recency, version as
        tiebreak. By COMMIT TIME, not version number — a gang restarted
        from an older checkpoint legitimately republishes lower version
        numbers, and those are the weights subscribers should follow
        (max-version ordering would instantly GC the rollback's publish
        while 'latest' kept pointing at the dead attempt's weights)."""
        return (float(manifest.get("ts", 0.0)),
                int(manifest.get("version", 0)))

    def _weights_latest_locked(self, name: str) -> Optional[int]:
        by_ver = self._weights_committed.get(name, {})
        if not by_ver:
            return None
        return max(by_ver.values(), key=self._weights_recency)["version"]

    def weights_latest_version(self, name: str) -> Optional[int]:
        """O(1)-payload poll target for subscribers — the full manifest
        (per-chunk tables + treedef bytes) must not ship on every
        staleness check."""
        with self._lock:
            return self._weights_latest_locked(name)

    def weights_has_version(self, name: str, version: int) -> bool:
        """O(1) committed-version probe (publishers pre-check replayed
        steps before paying the local shard copy into the store)."""
        with self._lock:
            return int(version) in self._weights_committed.get(name, {})

    def _weights_commit_locked(self, name: str, version: int,
                               pend: Dict[str, Any]) -> Dict[str, Any]:
        """Merge host fragments into the version manifest. Must hold the
        lock; records the publish event.

        Delta fragments mark unchanged leaves ``from_base``: those
        inherit the named base manifest's chunk entries FOR THAT HOST
        (entries are host-tagged at commit exactly so this attribution
        survives the merge). The committed manifest is therefore always
        self-contained — chains of deltas collapse one link per commit,
        and a version stays fetchable no matter which of its ancestors
        GC later drops. ``delta_bytes`` records what the publish
        actually shipped; ``total_bytes`` stays the full resolved
        size."""
        frags = pend["fragments"]
        by_ver = self._weights_committed.get(name, {})
        n_leaves = max(int(f.get("n_leaves", 0)) for f in frags.values())
        leaves: List[Dict[str, Any]] = []
        total = 0
        delta_bytes = 0
        n_chunks = 0
        changed: List[int] = []
        any_delta = any(f.get("base_version") is not None
                        for f in frags.values())
        for i in range(n_leaves):
            meta = None
            shards: List[Dict[str, Any]] = []
            leaf_changed = False
            for host, f in sorted(frags.items()):
                m = f["leaves"].get(str(i))
                if m is None:
                    continue
                meta = meta or m
                if m.get("from_base"):
                    base = by_ver[int(f["base_version"])]
                    shards.extend(
                        s for s in base["leaves"][i]["shards"]
                        if s.get("host", host) == host)
                else:
                    own = [dict(s, host=host) for s in m["shards"]]
                    shards.extend(own)
                    if own:
                        leaf_changed = True
                        delta_bytes += sum(int(s["nbytes"])
                                           for s in own)
            total += sum(int(s["nbytes"]) for s in shards)
            n_chunks += len(shards)
            if leaf_changed:
                changed.append(i)
            leaves.append({"shape": meta["shape"], "dtype": meta["dtype"],
                           "hash": meta.get("hash"), "shards": shards})
        treedef = next((f["treedef"] for _, f in sorted(frags.items())
                        if f.get("treedef") is not None), None)
        manifest = {"name": name, "version": version,
                    "step": pend.get("step"), "run_id": pend.get("run_id"),
                    "ts": time.time(), "num_hosts": pend["num_hosts"],
                    "n_leaves": n_leaves, "n_chunks": n_chunks,
                    "total_bytes": total, "leaves": leaves,
                    "treedef": treedef,
                    "delta": any_delta,
                    "base_version": next(
                        (int(f["base_version"]) for f in frags.values()
                         if f.get("base_version") is not None), None),
                    "changed_leaves": changed if any_delta else None,
                    "delta_bytes": delta_bytes}
        self._weights_committed[name][version] = manifest
        self._weight_event_locked(
            {"kind": "publish", "name": name, "version": version,
             "step": pend.get("step"), "run_id": pend.get("run_id"),
             "num_hosts": pend["num_hosts"], "bytes": total,
             "delta_bytes": delta_bytes if any_delta else None,
             "changed_leaves": len(changed) if any_delta else None})
        return manifest

    def _weights_live_ids_locked(self, name: str) -> set:
        """Chunk object ids referenced by the KEPT manifests and pending
        fragments of `name`. Delta manifests inherit their base's chunk
        entries, so dropping a base version must free only the ids no
        kept manifest still points at."""
        live = set(self._weights_object_ids(
            m["leaves"] for m in
            self._weights_committed.get(name, {}).values()))
        for (n, _v), pend in self._weights_pending.items():
            if n == name:
                live.update(self._weights_object_ids(
                    f["leaves"] for f in pend["fragments"].values()))
        return live

    def _weights_gc_locked(self, name: str,
                           keep: Optional[int]) -> List[Dict[str, Any]]:
        """Drop committed versions beyond keep-last-K (config
        weights_keep when `keep` is None). Returns the pubsub messages
        telling producers which versions' chunks to free — publish them
        AFTER releasing the lock. Ids still referenced by a kept
        manifest (delta inheritance) are withheld from the notice."""
        from .config import config

        keep = config.weights_keep if keep is None else int(keep)
        by_ver = self._weights_committed.get(name, {})
        order = sorted(by_ver,
                       key=lambda v: self._weights_recency(by_ver[v]))
        drop = order[:-keep] if keep > 0 else order
        msgs = []
        for v in drop:
            manifest = by_ver.pop(v)
            self._dirty = True
            self._weight_event_locked(
                {"kind": "gc", "name": name, "version": v})
            live = self._weights_live_ids_locked(name)
            dead = [oid for oid in self._weights_object_ids(
                        [manifest["leaves"]])
                    if oid not in live]
            msgs.append({"kind": "gc", "name": name, "versions": [v],
                         "object_ids": dead})
        return msgs

    def weights_gc(self, name: str, keep: Optional[int] = None) -> int:
        """Operator GC: keep only the newest
        `keep` versions of `name`. Returns the number dropped. Only an
        EXPLICIT keep=0 drops everything; a negative keep (operator
        typo) is rejected rather than read as drop-all."""
        if keep is not None and int(keep) < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        with self._cv:
            msgs = self._weights_gc_locked(name, keep)
            self._notify_all_locked()
        for msg in msgs:
            self.publish("weights", msg)
        return len(msgs)

    def weights_reap(self, max_age_s: Optional[float] = None) -> int:
        """Drop pending publishes older than `max_age_s` (config
        weights_publish_ttl_s default) — a producer chaos-killed
        mid-publish must never leave a forever-pending entry, and its
        surviving peers' orphan chunks must be freed. Runs from the
        monitor loop; tests call it with 0 for determinism."""
        from .config import config

        ttl = config.weights_publish_ttl_s if max_age_s is None \
            else float(max_age_s)
        now = time.monotonic()
        msgs = []
        with self._cv:
            for key in [k for k, p in self._weights_pending.items()
                        if now - p["started"] >= ttl]:
                name, version = key
                pend = self._weights_pending.pop(key)
                self._dirty = True
                self._weight_event_locked(
                    {"kind": "reap", "name": name, "version": version})
                msgs.append({"kind": "reaped", "name": name,
                             "versions": [version],
                             "object_ids": self._weights_object_ids(
                                 f["leaves"] for f in
                                 pend["fragments"].values())})
            if msgs:
                self._notify_all_locked()
        for msg in msgs:
            self.publish("weights", msg)
        return len(msgs)

    def weights_get_manifest(self, name: str,
                             version: Optional[int] = None
                             ) -> Optional[Dict[str, Any]]:
        """The full manifest of `version` (latest committed when None),
        or None when nothing is committed / the version was GC'd."""
        with self._lock:
            by_ver = self._weights_committed.get(name, {})
            if not by_ver:
                return None
            v = self._weights_latest_locked(name) if version is None \
                else int(version)
            return by_ver.get(v)

    def get_weight_versions(self) -> Dict[str, Any]:
        """Registry state for util.state.weight_versions() — one
        summary per name, manifests without the per-shard chunk lists."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name, by_ver in self._weights_committed.items():
                if not by_ver:
                    continue
                out[name] = {
                    "latest": self._weights_latest_locked(name),
                    "versions": [
                        {k: m.get(k) for k in (
                            "version", "step", "run_id", "ts",
                            "num_hosts", "n_leaves", "n_chunks",
                            "total_bytes", "delta", "base_version",
                            "delta_bytes")}
                        for m in sorted(
                            by_ver.values(),
                            key=self._weights_recency)],
                }
            pending = [{"name": n, "version": v,
                        "hosts_committed":
                            sorted(p["fragments"]),
                        "num_hosts": p["num_hosts"],
                        "age_s": round(time.monotonic() - p["started"], 3)}
                       for (n, v), p in self._weights_pending.items()]
            return {"names": out, "pending": pending}

    # ------------------------------------------------ disaggregated serving
    # Prefill servers, decode servers and routers (serve/disagg.py) push
    # stat snapshots and kv_publish / kv_transfer / shed markers;
    # util.state.disagg_status() and the merged timeline's `disagg` lane
    # read them.

    _DISAGG_EVENTS_KEPT = 10_000
    _DISAGG_STATS_KEPT = 256
    # a router's live queue depth counts only while its snapshot is this
    # fresh (a dead router's last word must not count for ever)
    _DISAGG_GAUGE_FRESH_S = 15.0

    @staticmethod
    def _keep_snapshot_locked(table: Dict[str, Dict[str, Any]], kept: int,
                              worker_id: str, component_id: str,
                              stats: Dict[str, Any]) -> None:
        table[str(component_id)] = dict(stats, worker_id=worker_id,
                                        component_id=str(component_id),
                                        ts=time.time())
        while len(table) > kept:
            del table[min(table, key=lambda k: table[k].get("ts", 0.0))]

    @staticmethod
    def _append_event_locked(log: List[Dict[str, Any]], event: Any,
                             kept: int) -> None:
        if not isinstance(event, dict):
            return
        event = dict(event)
        event.setdefault("ts", time.time())
        log.append(event)
        if len(log) > kept:
            del log[:len(log) - kept]

    def report_disagg_stats(self, worker_id: str, component_id: str,
                            stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._disagg_stats,
                                       self._DISAGG_STATS_KEPT, worker_id,
                                       component_id, stats)

    def get_disagg_status(self) -> Dict[str, Any]:
        """Components by role (prefill / decode / router) and cluster
        totals: transfers, KV bytes split shm / rpc, adoptions, sheds,
        the live queue depth."""
        with self._lock:
            comps = {k: dict(v) for k, v in self._disagg_stats.items()}
        now = time.time()
        prefill = {k: v for k, v in comps.items()
                   if v.get("role") == "prefill"}
        decode = {k: v for k, v in comps.items()
                  if v.get("role") == "decode"}
        routers = {k: v for k, v in comps.items()
                   if v.get("role") == "router"}

        def total(group, key):
            return sum(int(c.get(key, 0)) for c in group.values())

        totals: Dict[str, Any] = {
            "prefill_replicas": len(prefill),
            "decode_replicas": len(decode),
            **{k: total(prefill, k) for k in (
                "prefills", "prefilled_tokens", "reused_tokens",
                "published_transfers", "published_bytes")},
            **{k: total(decode, k) for k in (
                "transfers", "kv_fetched_bytes", "shm_bytes", "rpc_bytes",
                "adopted", "decoded_tokens")},
            "dispatched": total(routers, "dispatched"),
            "shed": total(routers, "shed"),
            "queue_depth": sum(
                int(r.get("pending", 0)) for r in routers.values()
                if now - float(r.get("ts", 0.0))
                <= self._DISAGG_GAUGE_FRESH_S),
            "max_queue_depth_seen": max(
                (int(r.get("max_pending", 0)) for r in routers.values()),
                default=0),
        }
        return {"prefill": prefill, "decode": decode, "routers": routers,
                "totals": totals}

    def report_disagg_event(self, event: Dict[str, Any]) -> None:
        """kv_publish / kv_transfer / shed / preempt / tier_wake markers
        for the merged timeline's disagg lane."""
        with self._lock:
            self._append_event_locked(self._disagg_events, event,
                                      self._DISAGG_EVENTS_KEPT)

    def get_disagg_events(self, limit: int = 10_000
                          ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._disagg_events[-limit:]

    # --------------------------------------------------- paged KV cache
    # Engines (models/engine.py) and prefill servers push kv_stats()
    # snapshots (their speculation counters ride the same push) and the
    # prefix-hit / evict / invalidate / spec_accept / spec_reject
    # markers; util.state.kv_cache_stats() and speculation_stats() read
    # them, the merged timeline's kvcache lane the markers.

    _KVCACHE_EVENTS_KEPT = 10_000
    _KVCACHE_TOTAL_KEYS = (
        "lookups", "hits", "partial_hits", "misses", "reused_tokens",
        "prefilled_tokens", "spliced_tokens", "inserted_blocks",
        "evictions", "cow_copies", "invalidations", "admitted",
        "prefill_admitted", "adopted", "prefill_calls",
        "spec_proposed", "spec_accepted", "spec_verify_ticks",
        "spec_emitted_tokens")

    def report_kvcache_stats(self, worker_id: str, engine_id: str,
                             stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        key = f"{str(worker_id)[:12]}:{engine_id}"
        with self._lock:
            self._kvcache_stats[key] = dict(
                stats, worker_id=worker_id, engine_id=engine_id,
                ts=time.time())

    def get_kvcache_stats(self) -> Dict[str, Any]:
        with self._lock:
            engines = {k: dict(v) for k, v in self._kvcache_stats.items()}
        totals: Dict[str, Any] = {k: 0 for k in self._KVCACHE_TOTAL_KEYS}
        for st in engines.values():
            for k in self._KVCACHE_TOTAL_KEYS:
                v = st.get(k)
                if isinstance(v, (int, float)):
                    totals[k] += v
        looked = totals["lookups"]
        totals["hit_rate"] = ((totals["hits"] + totals["partial_hits"])
                              / looked if looked else 0.0)
        seen = totals["reused_tokens"] + totals["prefilled_tokens"]
        totals["token_reuse_rate"] = (totals["reused_tokens"] / seen
                                      if seen else 0.0)
        return {"engines": engines, "totals": totals}

    def get_speculation_stats(self) -> Dict[str, Any]:
        """The speculation slice of the kvcache snapshots: engines that
        never speculated are left out of `engines`; the totals are
        returned all the same."""
        from ..util.state import speculation_totals

        with self._lock:
            snaps = {k: dict(v) for k, v in self._kvcache_stats.items()}
        engines = {k: {
            "engine_id": v.get("engine_id"),
            "speculate_k": v.get("speculate_k", 0),
            "spec_proposed": v.get("spec_proposed", 0),
            "spec_accepted": v.get("spec_accepted", 0),
            "spec_verify_ticks": v.get("spec_verify_ticks", 0),
            "spec_emitted_tokens": v.get("spec_emitted_tokens", 0),
            "acceptance_rate": v.get("acceptance_rate", 0.0),
            "tokens_per_verify": v.get("tokens_per_verify", 0.0),
            "kv_int8": v.get("kv_int8", False),
            "ts": v.get("ts"),
        } for k, v in snaps.items() if v.get("speculate_k")}
        return {"engines": engines, "totals": speculation_totals(engines)}

    def report_kvcache_event(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._append_event_locked(self._kvcache_events, event,
                                      self._KVCACHE_EVENTS_KEPT)

    def get_kvcache_events(self, limit: int = 10_000
                           ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._kvcache_events[-limit:]

    # ------------------------------------------------------ LoRA tenants
    # Adapter pools (serve/lora.py) push paging snapshots, routers their
    # tenant counters; util.state.lora_status() reads the aggregate, the
    # merged timeline's lora lane the page_in / evict / swap markers.

    _LORA_STATS_KEPT = 256
    _LORA_EVENTS_KEPT = 10_000

    def report_lora_stats(self, worker_id: str, component_id: str,
                          stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._lora_stats,
                                       self._LORA_STATS_KEPT, worker_id,
                                       component_id, stats)

    def get_lora_status(self) -> Dict[str, Any]:
        """Pool snapshots, router tenant counters, a per-tenant rollup
        and cluster totals."""
        with self._lock:
            comps = {k: dict(v) for k, v in self._lora_stats.items()}
        pools = {k: v for k, v in comps.items() if v.get("role") == "pool"}
        routers = {k: v for k, v in comps.items()
                   if v.get("role") == "router"}
        tenants: Dict[str, Dict[str, Any]] = {}

        def agg(t: str) -> Dict[str, Any]:
            return tenants.setdefault(
                t, {"hits": 0, "misses": 0, "evictions": 0, "swaps": 0,
                    "dispatched": 0, "completed": 0, "shed": 0,
                    "slo_misses": 0})

        for p in pools.values():
            for t, ts in (p.get("tenants") or {}).items():
                a = agg(t)
                for key in ("hits", "misses", "evictions", "swaps"):
                    a[key] += int(ts.get(key, 0))
        for r in routers.values():
            for t, ts in (r.get("tenants") or {}).items():
                a = agg(t)
                for key in ("dispatched", "completed", "shed",
                            "slo_misses"):
                    a[key] += int(ts.get(key, 0))

        def total(key: str) -> int:
            return sum(int(p.get(key, 0)) for p in pools.values())

        acquires, hits = total("acquires"), total("hits")
        totals: Dict[str, Any] = {
            "pools": len(pools), "routers": len(routers),
            "slots": total("slots"), "resident": total("resident"),
            "pinned": total("pinned"), "acquires": acquires, "hits": hits,
            "misses": total("misses"), "evictions": total("evictions"),
            "swaps": total("swaps"), "page_in_bytes": total("page_in_bytes"),
            "hit_rate": hits / acquires if acquires else 0.0,
            "tenants": len(tenants)}
        return {"pools": pools, "routers": routers, "tenants": tenants,
                "totals": totals}

    def report_lora_event(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._append_event_locked(self._lora_events, event,
                                      self._LORA_EVENTS_KEPT)

    def get_lora_events(self, limit: int = 10_000) -> List[Dict[str, Any]]:
        with self._lock:
            return self._lora_events[-limit:]

    # ------------------------------------------------ HTTP front door
    # Gateway replicas (serve/gateway.py) push request counters by
    # priority class and status code plus TTFT windows; the QoS gate and
    # routers push instant markers for the merged timeline's gateway
    # lane. util.state.gateway_status() reads the aggregate.

    _GATEWAY_EVENTS_KEPT = 10_000
    _GATEWAY_STATS_KEPT = 64

    def report_gateway_stats(self, worker_id: str, component_id: str,
                             stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._gateway_stats,
                                       self._GATEWAY_STATS_KEPT, worker_id,
                                       component_id, stats)

    def get_gateway_status(self) -> Dict[str, Any]:
        """Per-replica snapshots and cluster totals: requests by outcome,
        the per-class accept / complete / shed / disconnect split, the
        status-code histogram, preemptions."""
        with self._lock:
            gateways = {k: dict(v)
                        for k, v in self._gateway_stats.items()}
        by_class: Dict[str, Dict[str, int]] = {}
        by_code: Dict[str, int] = {}
        for g in gateways.values():
            for cls, row in (g.get("by_class") or {}).items():
                agg = by_class.setdefault(cls, {})
                for k, v in row.items():
                    agg[k] = agg.get(k, 0) + int(v)
            for code, n in (g.get("by_code") or {}).items():
                by_code[code] = by_code.get(code, 0) + int(n)
        totals: Dict[str, Any] = {
            "gateways": len(gateways),
            "by_class": by_class,
            "by_code": by_code,
        }
        for key in ("accepted", "completed", "streamed", "tokens_out",
                    "rate_limited", "sheds", "disconnects", "errors",
                    "preemptions"):
            totals[key] = sum(int(g.get(key, 0))
                              for g in gateways.values())
        return {"gateways": gateways, "totals": totals}

    def report_gateway_event(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._append_event_locked(self._gateway_events, event,
                                      self._GATEWAY_EVENTS_KEPT)

    def get_gateway_events(self, limit: int = 10_000
                           ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._gateway_events[-limit:]

    # ------------------------------------------------ request traces
    # Each process's RequestTraceStore (observability/requests.py) pushes
    # its retention stats and its recent summaries; every kept trace
    # rides the event log as a kind="trace" record, and tiers in other
    # processes push kind="phase" child records under the same request
    # id. util.state.requesttrace_status() / request_trace() and the
    # merged timeline's requests lane read them.

    _REQTRACE_EVENTS_KEPT = 10_000
    _REQTRACE_STATS_KEPT = 64

    def report_requesttrace_stats(self, worker_id: str, component_id: str,
                                  stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._requesttrace_stats,
                                       self._REQTRACE_STATS_KEPT,
                                       worker_id, component_id, stats)

    def get_requesttrace_status(self) -> Dict[str, Any]:
        """Per-store snapshots, cluster totals, the cluster's slowest
        requests, and the p99 attribution over every store's merged
        recent summaries."""
        from ..observability.requests import p99_attribution

        with self._lock:
            stores = {k: dict(v)
                      for k, v in self._requesttrace_stats.items()}
        totals: Dict[str, Any] = {"stores": len(stores)}
        for key in ("completed", "kept", "dropped", "replayed_requests",
                    "preempted_requests"):
            totals[key] = sum(int(s.get(key, 0)) for s in stores.values())
        outcomes: Dict[str, int] = {}
        slowest: List[Dict[str, Any]] = []
        merged_recent: List[Dict[str, Any]] = []
        for s in stores.values():
            for k, v in (s.get("outcomes") or {}).items():
                outcomes[k] = outcomes.get(k, 0) + int(v)
            slowest.extend(s.get("slowest") or [])
            merged_recent.extend(s.get("recent") or [])
        totals["outcomes"] = outcomes
        totals["slowest_ms"] = max(
            [float(s.get("slowest_ms", 0.0)) for s in stores.values()],
            default=0.0)
        slowest.sort(key=lambda r: float(r.get("total_ms") or 0.0),
                     reverse=True)
        return {"stores": stores, "totals": totals,
                "slowest": slowest[:32],
                "attribution": p99_attribution(merged_recent)}

    def report_requesttrace_event(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._append_event_locked(self._requesttrace_events, event,
                                      self._REQTRACE_EVENTS_KEPT)

    def get_requesttrace_events(self, limit: int = 10_000
                                ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._requesttrace_events[-limit:]

    def get_request_trace(self, request_id: str
                          ) -> Optional[Dict[str, Any]]:
        """The newest kept trace under the id, with the kind="phase"
        records other processes pushed for it as `remote_phases`."""
        rid = str(request_id)
        with self._lock:
            events = list(self._requesttrace_events)
        trace = None
        for ev in reversed(events):
            if ev.get("kind") == "trace" \
                    and str(ev.get("request_id")) == rid:
                trace = dict(ev)
                break
        if trace is None:
            return None
        remote = [dict(ev) for ev in events
                  if ev.get("kind") == "phase"
                  and str(ev.get("request_id")) == rid]
        if remote:
            trace["remote_phases"] = remote
        return trace

    # ------------------------------------------------------ global KV plane
    # Prefill servers (their tier-2 arenas, tier-3 counters) and routers
    # (directory outcomes) push snapshots and spill / tier2_hit /
    # tier3_publish / tier3_adopt / directory_hit markers; the prefix
    # directory lives here (the weight registry's pattern: atomic
    # commit, TTL reap, keep-last-K GC).

    _KVPLANE_EVENTS_KEPT = 10_000
    _KVPLANE_STATS_KEPT = 256
    _KVPLANE_DIR_KEPT = 4096
    _KVPLANE_GAUGE_FRESH_S = 15.0
    # a directory entry's TTL (the JAX package's RAY_TPU_KVPLANE_T3_TTL_S
    # default); a lookup or a reap may pass its own
    KVPLANE_T3_TTL_S = 600.0
    _KVPLANE_TOTAL_KEYS = (
        "spills", "spill_bytes", "tier2_hits", "tier2_probes",
        "tier2_reused_tokens", "tier2_fetched_bytes",
        "arena_evictions", "tier3_publishes", "tier3_adopts",
        "tier3_adopted_blocks", "tier3_reused_tokens",
        "tier3_fetched_bytes", "directory_hits", "directory_misses",
        "directory_fallbacks")

    def report_kvplane_stats(self, worker_id: str, component_id: str,
                             stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._kvplane_stats,
                                       self._KVPLANE_STATS_KEPT, worker_id,
                                       component_id, stats)

    def get_kvplane_stats(self) -> Dict[str, Any]:
        with self._lock:
            comps = {k: dict(v) for k, v in self._kvplane_stats.items()}
        now = time.time()
        totals: Dict[str, Any] = {k: 0 for k in self._KVPLANE_TOTAL_KEYS}
        for st in comps.values():
            for k in self._KVPLANE_TOTAL_KEYS:
                v = st.get(k)
                if isinstance(v, (int, float)):
                    totals[k] += v
        fresh = [c for c in comps.values()
                 if now - float(c.get("ts", 0.0))
                 <= self._KVPLANE_GAUGE_FRESH_S]
        totals["arena_entries"] = sum(int(c.get("entries", 0))
                                      for c in fresh)
        totals["arena_bytes"] = sum(int(c.get("bytes", 0)) for c in fresh)
        probes = totals["tier2_probes"]
        totals["tier2_hit_rate"] = (totals["tier2_hits"] / probes
                                    if probes else 0.0)
        looks = totals["directory_hits"] + totals["directory_misses"]
        totals["directory_hit_rate"] = (totals["directory_hits"] / looks
                                        if looks else 0.0)
        return {"components": comps, "totals": totals}

    def get_kvplane_status(self) -> Dict[str, Any]:
        """Component snapshots, cluster totals and the prefix directory's
        summary (entries, bytes, per-namespace counts, counters)."""
        out = self.get_kvplane_stats()
        with self._lock:
            per_ns: Dict[str, int] = {}
            total_bytes = 0
            for (ns, _d), e in self._kvplane_dir.items():
                per_ns[ns] = per_ns.get(ns, 0) + 1
                total_bytes += int(e.get("nbytes", 0))
            out["directory"] = {
                "entries": len(self._kvplane_dir), "nbytes": total_bytes,
                "namespaces": per_ns,
                "counters": dict(self._kvplane_dir_counters)}
        return out

    def report_kvplane_event(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._append_event_locked(self._kvplane_events, event,
                                      self._KVPLANE_EVENTS_KEPT)

    def get_kvplane_events(self, limit: int = 10_000
                           ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._kvplane_events[-limit:]

    def kvplane_publish(self, namespace: str, digest: str,
                        meta: Dict[str, Any]) -> Dict[str, Any]:
        """Atomic, metadata-only commit of one published prefix. A digest
        already committed returns ``status: already`` and the first
        holder keeps serving. Error dicts, never raises."""
        if not isinstance(meta, dict) or not meta.get("holder"):
            return {"error": "kvplane_publish needs a holder in meta"}
        if not digest:
            return {"error": "kvplane_publish needs a digest"}
        key = (str(namespace or ""), str(digest))
        now = time.time()
        with self._lock:
            existing = self._kvplane_dir.get(key)
            if existing is not None:
                existing["republished"] = now
                self._kvplane_dir_counters["republishes"] += 1
                return {"status": "already",
                        "holder": existing.get("holder")}
            self._kvplane_dir[key] = dict(
                meta, namespace=key[0], digest=key[1], ts=now,
                started=time.monotonic(), last_hit=None, hits=0)
            self._kvplane_dir_counters["publishes"] += 1
            # the overall bound, oldest by recency first
            while len(self._kvplane_dir) > self._KVPLANE_DIR_KEPT:
                del self._kvplane_dir[min(
                    self._kvplane_dir,
                    key=lambda k: (self._kvplane_dir[k].get("last_hit")
                                   or self._kvplane_dir[k]["ts"]))]
                self._kvplane_dir_counters["gced"] += 1
            self._kvplane_events.append(
                {"kind": "tier3_publish", "namespace": key[0],
                 "digest": key[1][:16], "holder": meta.get("holder"),
                 "tokens": meta.get("tokens"),
                 "nbytes": meta.get("nbytes"), "ts": now})
        self.publish("kvplane", {"event": "publish", "digest": key[1],
                                 "namespace": key[0],
                                 "holder": meta.get("holder")})
        return {"status": "committed"}

    def kvplane_lookup(self, namespace: str, digests: List[str],
                       ttl_s: Optional[float] = None
                       ) -> Optional[Dict[str, Any]]:
        """The longest registered prefix among `digests` (longest
        first). An entry older than `ttl_s` (default KVPLANE_T3_TTL_S; 0
        disables the check) is a miss and is dropped here."""
        ns = str(namespace or "")
        ttl = self.KVPLANE_T3_TTL_S if ttl_s is None else float(ttl_s)
        now_m = time.monotonic()
        with self._lock:
            self._kvplane_dir_counters["lookups"] += 1
            for d in list(digests or [])[:64]:
                key = (ns, str(d))
                e = self._kvplane_dir.get(key)
                if e is None:
                    continue
                if ttl > 0 and now_m - e.get("started", now_m) > ttl:
                    del self._kvplane_dir[key]
                    self._kvplane_dir_counters["reaped"] += 1
                    continue
                e["last_hit"] = time.time()
                e["hits"] = int(e.get("hits", 0)) + 1
                self._kvplane_dir_counters["directory_hits"] += 1
                return {k: v for k, v in e.items() if k != "started"}
            self._kvplane_dir_counters["directory_misses"] += 1
        return None

    def kvplane_unpublish(self, namespace: str, digest: str) -> bool:
        """The holder retracts an entry (its refs died)."""
        key = (str(namespace or ""), str(digest))
        with self._lock:
            e = self._kvplane_dir.pop(key, None)
            if e is not None:
                self._kvplane_dir_counters["unpublished"] += 1
        return e is not None

    def kvplane_reap(self, max_age_s: Optional[float] = None) -> int:
        """Drop directory entries older than `max_age_s` (default
        KVPLANE_T3_TTL_S) on the monotonic commit clock."""
        ttl = self.KVPLANE_T3_TTL_S if max_age_s is None \
            else float(max_age_s)
        now_m = time.monotonic()
        reaped = 0
        with self._lock:
            for key, e in list(self._kvplane_dir.items()):
                if now_m - e.get("started", now_m) >= ttl:
                    del self._kvplane_dir[key]
                    self._kvplane_dir_counters["reaped"] += 1
                    reaped += 1
            if reaped:
                self._kvplane_events.append(
                    {"kind": "reap", "entries": reaped, "ts": time.time()})
        return reaped

    def kvplane_gc(self, keep: int, namespace: Optional[str] = None) -> int:
        """Keep the newest `keep` entries (by last hit, else commit
        time), per namespace or over the whole directory."""
        keep = max(0, int(keep))
        dropped = 0
        with self._lock:
            keys = [k for k in self._kvplane_dir
                    if namespace is None or k[0] == str(namespace or "")]
            if len(keys) > keep:
                keys.sort(key=lambda k: (self._kvplane_dir[k].get("last_hit")
                                         or self._kvplane_dir[k]["ts"]),
                          reverse=True)
                for k in keys[keep:]:
                    del self._kvplane_dir[k]
                    self._kvplane_dir_counters["gced"] += 1
                    dropped += 1
            if dropped:
                self._kvplane_events.append(
                    {"kind": "gc", "entries": dropped, "ts": time.time()})
        return dropped

    # ------------------------------------------- serving fault tolerance
    # Routers push failover and shed accounting, healers (the autoscaler's
    # self-healer) deaths, replacements and breaker trips; the failover,
    # replica_death, replace and breaker_trip markers themselves ride the
    # resilience event log.

    _SERVEFAULT_STATS_KEPT = 128
    _SERVEFAULT_EVENT_KINDS = ("failover", "replace", "breaker_trip",
                               "replica_death", "chaos", "serve_drain")

    def report_servefault_stats(self, worker_id: str, component_id: str,
                                stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._servefault_stats,
                                       self._SERVEFAULT_STATS_KEPT,
                                       worker_id, component_id, stats)

    def get_servefault_status(self) -> Dict[str, Any]:
        """Router snapshots (failovers by phase, sheds by cause, corpses
        removed), healer snapshots, and cluster totals."""
        with self._lock:
            comps = {k: dict(v) for k, v in self._servefault_stats.items()}
        routers = {k: v for k, v in comps.items()
                   if v.get("role") == "router"}
        healers = {k: v for k, v in comps.items()
                   if v.get("role") == "healer"}
        tiers = ("prefill", "decode")

        def tiered(snaps, key):
            return {t: sum(int((s.get(key) or {}).get(t, 0))
                           for s in snaps.values()) for t in tiers}

        sheds_by_cause: Dict[str, int] = {}
        for r in routers.values():
            for cause, n in (r.get("sheds_by_cause") or {}).items():
                sheds_by_cause[cause] = sheds_by_cause.get(cause, 0) + int(n)
        totals: Dict[str, Any] = {
            "routers": len(routers), "healers": len(healers),
            "failovers": tiered(routers, "failovers"),
            "failovers_total": sum(sum((r.get("failovers") or {}).values())
                                   for r in routers.values()),
            "failover_requests": sum(int(r.get("failover_requests", 0))
                                     for r in routers.values()),
            "sheds_by_cause": sheds_by_cause,
            "removed_dead": tiered(routers, "removed_dead"),
            "deaths": tiered(healers, "deaths"),
            "replacements": tiered(healers, "replacements"),
            "replacements_total": sum(
                sum((h.get("replacements") or {}).values())
                for h in healers.values()),
            **{k: sum(int(h.get(k, 0)) for h in healers.values())
               for k in ("replacements_blocked", "breaker_trips",
                         "drains_reaped")},
        }
        return {"routers": routers, "healers": healers, "totals": totals}

    def get_servefault_events(self, limit: int = 10_000
                              ) -> List[Dict[str, Any]]:
        """The servefault slice of the resilience event log."""
        with self._lock:
            events = list(self._resilience_events)
        kinds = self._SERVEFAULT_EVENT_KINDS
        return [e for e in events if e.get("kind") in kinds][-limit:]

    # ---------------------------------------------------- serving autoscaler
    # Autoscale loops (serve/autoscale.py) push status snapshots and
    # scale_up / drain / scale_down markers; util.state.autoscaler_status()
    # reads the aggregate, the timeline's autoscale lane the markers.

    _AUTOSCALE_STATS_KEPT = 64
    _AUTOSCALE_EVENTS_KEPT = 10_000

    def report_autoscale_stats(self, worker_id: str, autoscaler_id: str,
                               stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._autoscale_stats,
                                       self._AUTOSCALE_STATS_KEPT,
                                       worker_id, autoscaler_id, stats)
            self._autoscale_stats[str(autoscaler_id)]["autoscaler_id"] = \
                str(autoscaler_id)

    def get_autoscale_status(self) -> Dict[str, Any]:
        """Per-loop snapshots and cluster totals: decisions by direction,
        drains, replica-seconds and active replicas per tier."""
        with self._lock:
            loops = {k: dict(v) for k, v in self._autoscale_stats.items()}
        tiers = ("prefill", "decode")
        totals: Dict[str, Any] = {
            "autoscalers": len(loops),
            "scale_ups": sum(sum(s.get("scale_ups", {}).values())
                             for s in loops.values()),
            "scale_downs": sum(sum(s.get("scale_downs", {}).values())
                               for s in loops.values()),
            "drains_completed": sum(int(s.get("drains_completed", 0))
                                    for s in loops.values()),
            "drains_forced": sum(int(s.get("drains_forced", 0))
                                 for s in loops.values()),
            "replica_seconds": {
                t: round(sum(float(s.get("replica_seconds", {}).get(t, 0.0))
                             for s in loops.values()), 3) for t in tiers},
            "active_replicas": {
                t: sum(int(s.get(f"{t}_active", 0)) for s in loops.values())
                for t in tiers},
        }
        return {"autoscalers": loops, "totals": totals}

    def report_autoscale_event(self, event: Dict[str, Any]) -> None:
        """scale_up / scale_down / drain / scale_from_zero / replica_death
        / replace markers for the timeline's autoscale lane."""
        with self._lock:
            self._append_event_locked(self._autoscale_events, event,
                                      self._AUTOSCALE_EVENTS_KEPT)

    def get_autoscale_events(self, limit: int = 10_000
                             ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._autoscale_events[-limit:]

    # ------------------------------------------------- online learning loop
    # Samplers, the rollout buffer and the learner (online/) push
    # snapshots and rollout / ingest / publish / swap markers;
    # util.state.online_status() reads the aggregate, the timeline's
    # online lane the markers.

    _ONLINE_EVENTS_KEPT = 10_000
    _ONLINE_STATS_KEPT = 256

    def report_online_stats(self, worker_id: str, component_id: str,
                            stats: Dict[str, Any]) -> None:
        if not isinstance(stats, dict):
            return
        with self._lock:
            self._keep_snapshot_locked(self._online_stats,
                                       self._ONLINE_STATS_KEPT, worker_id,
                                       component_id, stats)

    def get_online_status(self) -> Dict[str, Any]:
        """Components by role (sampler / buffer / learner) and cluster
        totals: rollouts, rollout tokens, swaps, buffer occupancy, the
        learner's ingest and the worst sampler staleness."""
        with self._lock:
            comps = {k: dict(v) for k, v in self._online_stats.items()}
        samplers = {k: v for k, v in comps.items()
                    if v.get("role") == "sampler"}
        buffers = {k: v for k, v in comps.items()
                   if v.get("role") == "buffer"}
        learners = {k: v for k, v in comps.items()
                    if v.get("role") == "learner"}

        def total(group, key):
            return sum(int(c.get(key, 0)) for c in group.values())

        totals: Dict[str, Any] = {
            "samplers": len(samplers),
            "rollouts": total(samplers, "rollouts"),
            "rollout_tokens": total(samplers, "rollout_tokens"),
            "swaps": total(samplers, "swap_count"),
            "buffer_occupancy": total(buffers, "occupancy"),
            "buffer_capacity": total(buffers, "capacity"),
            "buffer_rejected": total(buffers, "rejected"),
            "ingested_rollouts": total(learners, "ingested_rollouts"),
            "ingested_tokens": total(learners, "ingested_tokens"),
            "learner_steps": max((int(v.get("steps", 0))
                                  for v in learners.values()), default=0),
            "published_versions": max(
                (int(v.get("published_version", 0))
                 for v in learners.values()), default=0),
        }
        stale = [s.get("staleness_versions") for s in samplers.values()
                 if s.get("staleness_versions") is not None]
        totals["staleness_versions"] = max(stale) if stale else None
        high = [s.get("max_staleness_versions") for s in samplers.values()
                if s.get("max_staleness_versions") is not None]
        totals["max_staleness_versions"] = max(high + stale) \
            if (high or stale) else None
        return {"samplers": samplers, "buffers": buffers,
                "learners": learners, "totals": totals}

    def report_online_event(self, event: Dict[str, Any]) -> None:
        """rollout / ingest / publish / swap markers for the timeline's
        online lane."""
        with self._lock:
            self._append_event_locked(self._online_events, event,
                                      self._ONLINE_EVENTS_KEPT)

    def get_online_events(self, limit: int = 10_000
                          ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._online_events[-limit:]

    # ------------------------------------------------------ flight recorder
    # Gang-wide step telemetry (observability/): every rank's StepTimer
    # ships per-step records here; the per-run ring buffer is the source
    # for straggler detection (util.state.train_progress) and the merged
    # timeline's step markers.

    _TRAIN_STEPS_KEPT = 1024   # per-run step window
    _TRAIN_RUNS_KEPT = 16      # oldest runs evicted past this

    def report_train_steps(self, run_id: str, rank: int,
                           records: List[Dict[str, Any]]) -> None:
        with self._lock:
            run = self._train_runs.setdefault(
                run_id, {"steps": {}, "updated": 0.0})
            steps = run["steps"]
            for rec in records:
                step = int(rec.get("step", 0))
                steps.setdefault(step, {})[int(rank)] = rec
            if len(steps) > self._TRAIN_STEPS_KEPT:
                for s in sorted(steps)[:len(steps)
                                       - self._TRAIN_STEPS_KEPT]:
                    del steps[s]
            run["updated"] = time.time()
            if len(self._train_runs) > self._TRAIN_RUNS_KEPT:
                oldest = sorted(self._train_runs,
                                key=lambda r:
                                self._train_runs[r]["updated"])
                for r in oldest[:len(self._train_runs)
                                - self._TRAIN_RUNS_KEPT]:
                    del self._train_runs[r]

    def get_train_progress(self) -> Dict[str, Any]:
        """Per-run gang summaries (per-rank stats, skew, stragglers) —
        aggregation math lives in observability.gang. Step
        records are write-once (inserted/replaced, never mutated), so a
        two-level shallow copy isolates the summarizer without paying a
        deep copy of up to 16k records inside the conductor lock."""
        from ..observability import gang

        with self._lock:
            snapshot = {
                run_id: {s: dict(by_rank)
                         for s, by_rank in run["steps"].items()}
                for run_id, run in self._train_runs.items()}
        return {run_id: gang.summarize_run(steps)
                for run_id, steps in snapshot.items()}

    def get_train_steps(self, limit: int = 10_000) -> List[Dict[str, Any]]:
        """Raw step records, flattened newest-last with run_id attached —
        the merged-timeline source (observability.timeline). Only a
        two-level shallow snapshot happens under the lock (records are
        write-once, see get_train_progress); the flatten/sort over
        potentially ~1M records runs outside it."""
        with self._lock:
            snapshot = {
                run_id: {s: dict(by_rank)
                         for s, by_rank in run["steps"].items()}
                for run_id, run in self._train_runs.items()}
        out: List[Dict[str, Any]] = []
        for run_id, steps in snapshot.items():
            for step in sorted(steps):
                for rank, rec in sorted(steps[step].items()):
                    out.append(dict(rec, run_id=run_id, rank=rank))
        out.sort(key=lambda r: r.get("t_start") or 0.0)
        return out[-limit:]

    # ------------------------------------------------------ MPMD pipelines
    # mpmd/: stage registry, channel mailbox, per-stage stats and
    # instant markers. util.state.pipeline_status() reads
    # get_pipeline_status, the timeline's pipeline lane the markers.

    _PIPELINE_EVENTS_KEPT = 10_000
    _PIPELINE_MAILBOX_CAP = 65_536
    _PIPELINES_KEPT = 16  # closed records retained (open ones never evict)

    def _pipeline_event_locked(self, event: Dict[str, Any]) -> None:
        event.setdefault("ts", time.time())
        self._pipeline_events.append(event)
        if len(self._pipeline_events) > self._PIPELINE_EVENTS_KEPT:
            del self._pipeline_events[
                :len(self._pipeline_events)
                - self._PIPELINE_EVENTS_KEPT]

    def pipeline_open(self, name: str,
                      spec: Dict[str, Any]) -> Dict[str, Any]:
        """Create (or replace) a pipeline registry entry. Reopening a
        name drops the previous generation's stages, stats, and any
        stale mailbox entries — a restarted driver must not deliver the
        dead run's activations."""
        num_stages = int(spec.get("num_stages", 0))
        if num_stages < 2:
            return {"error": f"num_stages must be >= 2, got "
                             f"{num_stages}"}
        if "/ch/" in name or name.endswith("/ch"):
            # "/ch/" delimits channel keys (pipeline_channel_put parses
            # the name back out of the key at its FIRST occurrence, and
            # a name ending in "/ch" would shift that occurrence)
            return {"error": f"pipeline name {name!r} must not "
                             "contain '/ch/' or end with '/ch'"}
        with self._lock:
            # "/ch/" delimiter (not a bare "/") so purging "train"
            # never touches a live "train/eval" pipeline's entries
            prefix = f"{name}/ch/"
            for key in [k for k in self._pipeline_mailbox
                        if k.startswith(prefix)]:
                del self._pipeline_mailbox[key]
            self._pipelines[name] = {
                "name": name,
                "num_stages": num_stages,
                "schedule": spec.get("schedule", "1f1b"),
                "num_microbatches": spec.get("num_microbatches"),
                "bubble_estimate": spec.get("bubble_estimate"),
                "run_id": spec.get("run_id", ""),
                "created": time.time(),
                "formed": False,
                "closed": False,
                "stages": {},
                "stats": {},
            }
            self._pipeline_event_locked(
                {"kind": "open", "pipeline": name,
                 "num_stages": num_stages,
                 "schedule": spec.get("schedule")})
        return {"ok": True}

    def pipeline_register_stage(self, name: str, stage: int,
                                info: Dict[str, Any]) -> Dict[str, Any]:
        """One stage-gang's registration. The pipeline flips formed=True
        atomically when the LAST of num_stages stages is in — partial
        pipelines are never visible as formed (the weights-fragment
        commit pattern)."""
        formed_now = False
        with self._lock:
            rec = self._pipelines.get(name)
            if rec is None or rec.get("closed"):
                return {"error": f"no open pipeline {name!r} — call "
                                 "pipeline_open first"}
            stage = int(stage)
            if not 0 <= stage < rec["num_stages"]:
                return {"error": f"stage {stage} out of range for "
                                 f"{rec['num_stages']}-stage pipeline"}
            reg_run = (info or {}).get("run_id")
            if rec.get("run_id") and reg_run is not None and \
                    reg_run != rec["run_id"]:
                # a stage from a DEAD generation (driver restarted and
                # reopened the name) must not count toward — or flip —
                # this generation's formation
                return {"error":
                        f"stage {stage} belongs to generation "
                        f"{reg_run!r}, not {rec['run_id']!r}"}
            rec["stages"][stage] = dict(info or {}, ts=time.time())
            self._pipeline_event_locked(
                {"kind": "stage_registered", "pipeline": name,
                 "stage": stage,
                 "slice_id": (info or {}).get("slice_id")})
            if not rec["formed"] and \
                    len(rec["stages"]) == rec["num_stages"]:
                rec["formed"] = True
                formed_now = True
                self._pipeline_event_locked(
                    {"kind": "formed", "pipeline": name,
                     "num_stages": rec["num_stages"]})
            formed = rec["formed"]
        if formed_now:
            self.publish("pipeline", {"kind": "formed", "name": name})
        return {"ok": True, "formed": formed}

    def pipeline_get(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._pipelines.get(name)
            if rec is None:
                return None
            out = dict(rec)
            out["stages"] = {s: dict(v)
                             for s, v in rec["stages"].items()}
            out["stats"] = {s: dict(v) for s, v in rec["stats"].items()}
            return out

    def pipeline_close(self, name: str) -> bool:
        """Mark the pipeline closed and drop its mailbox entries (the
        senders' chunk refs die with the stage actors)."""
        with self._lock:
            rec = self._pipelines.get(name)
            if rec is None:
                return False
            rec["closed"] = True
            prefix = f"{name}/ch/"
            dropped = [k for k in self._pipeline_mailbox
                       if k.startswith(prefix)]
            for key in dropped:
                del self._pipeline_mailbox[key]
            self._pipeline_event_locked(
                {"kind": "closed", "pipeline": name,
                 "dropped_mailbox": len(dropped)})
            # keep-last-K of CLOSED records (the weights-registry GC
            # pattern): a sweep of uniquely-named runs must not grow
            # the registry — and every status payload — forever
            closed = sorted(
                (n for n, r in self._pipelines.items()
                 if r.get("closed")),
                key=lambda n: self._pipelines[n].get("created", 0.0))
            for n in closed[:max(0, len(closed) - self._PIPELINES_KEPT)]:
                del self._pipelines[n]
        return True

    def pipeline_channel_put(self, key: str,
                             desc: Dict[str, Any]) -> Dict[str, Any]:
        """Register one microbatch payload's chunk descriptor
        (metadata only). Single-slot per key: the schedules never
        produce the same (step, mb, kind) twice."""
        if not isinstance(desc, dict):
            return {"error": "descriptor must be a dict"}
        from ..util.runtime import pipeline_run_token

        name, _, rest = str(key).partition("/ch/")
        with self._lock:
            rec = self._pipelines.get(name)
            if rec is None or rec.get("closed"):
                # a stage-gang of a closed/GC-evicted (dead) generation
                # must fail its sends instead of leaking undeliverable
                # entries toward the global mailbox cap
                return {"error": f"pipeline {name!r} is not open — "
                                 "pipeline_open must precede channel "
                                 "sends"}
            run = rest.split("/", 1)[0]
            want = pipeline_run_token(str(rec["run_id"])) \
                if rec.get("run_id") else ""
            if want and run != want:
                # same generation fencing as stage registration: an
                # orphaned old gang's sends must fail fast, not pile
                # up as undeliverable entries under the live name
                return {"error":
                        f"channel key belongs to generation {run!r}, "
                        f"not {want!r}"}
            if len(self._pipeline_mailbox) >= self._PIPELINE_MAILBOX_CAP:
                return {"error":
                        f"pipeline mailbox full "
                        f"({self._PIPELINE_MAILBOX_CAP} entries) — "
                        "receiver stages dead or wedged?"}
            self._pipeline_mailbox[str(key)] = desc
        self.publish("pipeline", {"kind": "channel_put", "key": key})
        return {"ok": True}

    def pipeline_channel_pending(self, keys: List[str]) -> List[str]:
        """Which of `keys` are still undelivered (the sender-side
        drain barrier — see ActivationChannel.drain)."""
        with self._lock:
            return [k for k in keys if str(k) in self._pipeline_mailbox]

    def pipeline_channel_discard(self, keys: List[str]) -> None:
        """Drop undelivered descriptors whose chunks the sender is
        about to free (retention pruning / channel close): a
        descriptor naming freed chunks must not stay deliverable —
        a late recv would die in an opaque fetch timeout — nor leak
        toward the mailbox cap."""
        with self._lock:
            for k in keys:
                self._pipeline_mailbox.pop(str(k), None)

    def pipeline_channel_take(self, key: str) -> Optional[Dict[str, Any]]:
        """Pop a descriptor (None while not yet delivered — receivers
        poll with a pubsub wakeup)."""
        with self._lock:
            return self._pipeline_mailbox.pop(str(key), None)

    def report_pipeline_stats(self, name: str, stage: int,
                              stats: Dict[str, Any]) -> None:
        """Per-stage run summary (bubble fraction, channel bytes,
        steps) from the stage-gangs — the one set of numbers every
        surface reports."""
        if not isinstance(stats, dict):
            return
        with self._lock:
            rec = self._pipelines.get(name)
            if rec is None:
                return
            run = stats.get("run_id")
            if rec.get("run_id") and run is not None and \
                    run != rec["run_id"]:
                # a dead generation must not overwrite the live run's
                # numbers (generation fencing, as registration)
                return
            rec["stats"][int(stage)] = dict(stats, ts=time.time())

    def get_pipeline_status(self) -> Dict[str, Any]:
        """State-API/dashboard view: every pipeline's registry record
        plus cross-stage totals (activation bytes, mean/max bubble)."""
        with self._lock:
            pipelines = {}
            for name, rec in self._pipelines.items():
                out = dict(rec)
                out["stages"] = {s: dict(v)
                                 for s, v in rec["stages"].items()}
                out["stats"] = {s: dict(v)
                                for s, v in rec["stats"].items()}
                pipelines[name] = out
            mailbox_depth = len(self._pipeline_mailbox)
        for rec in pipelines.values():
            stats = rec["stats"].values()
            fracs = [s.get("bubble_fraction") for s in stats
                     if s.get("bubble_fraction") is not None]
            rec["totals"] = {
                "activation_bytes": sum(int(s.get("sent_bytes") or 0)
                                        for s in stats),
                "bubble_fraction_mean": (sum(fracs) / len(fracs)
                                         if fracs else None),
                "bubble_fraction_max": max(fracs) if fracs else None,
                "steps": max((int(s.get("steps") or 0) for s in stats),
                             default=0),
            }
        return {"pipelines": pipelines, "mailbox_depth": mailbox_depth}

    def report_pipeline_event(self, event: Dict[str, Any]) -> None:
        """Instant markers (formed / stage_report / stage_death /
        closed) for the merged timeline's pipeline lane."""
        if not isinstance(event, dict):
            return
        with self._lock:
            self._pipeline_event_locked(dict(event))

    def get_pipeline_events(self, limit: int = 10_000
                            ) -> List[Dict[str, Any]]:
        with self._lock:
            return self._pipeline_events[-limit:]

    # ------------------------------------------------------------------ jobs
    # Reference: GcsJobManager + dashboard/modules/job JobManager —
    # entrypoint drivers run as head-node subprocesses with RTT_ADDRESS
    # and RTT_JOB_ID in the head's environment, logs captured per job.

    def submit_job(self, entrypoint: str,
                   env: Optional[Dict[str, str]] = None,
                   submission_id: Optional[str] = None,
                   working_dir: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   runtime_env: Optional[Dict[str, Any]] = None) -> str:
        """`runtime_env`: the job's whole runtime_env (validated by the
        client). The entrypoint runs with its env_vars, in its
        working_dir, with its py_modules on PYTHONPATH; its driver gives
        all of it to every task and actor it submits (RTT_JOB_RUNTIME_ENV)."""
        import json as _json
        import uuid as _uuid

        from . import runtime_env as renv

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
        if runtime_env:
            penv[renv.ENV_JOB] = _json.dumps(runtime_env)
            mods = [os.path.abspath(m)
                    for m in runtime_env.get("py_modules") or []]
            if mods:
                penv["PYTHONPATH"] = os.pathsep.join(
                    mods + ([penv["PYTHONPATH"]]
                            if penv.get("PYTHONPATH") else []))
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
                # the weight registry (metadata only: chunks live in
                # their producers' stores and survive a conductor
                # restart; a forgotten registry could never send the
                # gc/reap notices those chunks' lifetimes depend on)
                "weights": {
                    "committed": {n: dict(bv) for n, bv in
                                  self._weights_committed.items()},
                    "pending": [
                        {"name": n, "version": v,
                         "num_hosts": p["num_hosts"],
                         "run_id": p.get("run_id", ""),
                         "step": p.get("step"),
                         "fragments": dict(p["fragments"])}
                        for (n, v), p in self._weights_pending.items()],
                },
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
            wstate = state.get("weights") or {}
            self._weights_committed = {
                n: {int(v): m for v, m in bv.items()}
                for n, bv in (wstate.get("committed") or {}).items()}
            for p in wstate.get("pending") or []:
                # a fresh TTL clock: `started` is monotonic and does not
                # survive a restart; the reaper ages them out from now
                self._weights_pending[(p["name"], int(p["version"]))] = {
                    "fragments": dict(p["fragments"]),
                    "num_hosts": int(p["num_hosts"]),
                    "run_id": p.get("run_id", ""), "step": p.get("step"),
                    "started": now}
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
        """Flush the snapshot, reap torn weight publishes, run the
        memory monitor, expire silent agent nodes, reap dead workers and restart their actors
        (reference gcs_health_check_manager.cc + gcs_actor_manager
        worker-death path)."""
        from .config import config

        last_mem_check = 0.0
        while not self._stopped:
            time.sleep(0.2)
            try:
                self._flush_state()
                self.weights_reap()
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
        self.handler._rpc_server = self.server
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
