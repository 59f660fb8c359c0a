"""Per-host node agent: the raylet-equivalent daemon of a worker host.

A NodeAgent joins a running cluster (`python -m ray_tpu_torch start
--address head:port`), registers its host's resources and GPUs with the
conductor, and owns that host's worker processes: the conductor asks the
agent to spawn a worker when a lease lands on this node, and the agent's
heartbeat reports worker exits (the conductor cannot poll remote pids).

Where the port differs from the JAX package's agent:
- GPUs: the agent counts its own (`torch.cuda.device_count()`, which
  honours the agent's CUDA_VISIBLE_DEVICES, or `--num-gpus`) and names
  them by its own visible ids in `register_node`. The conductor leases
  them by pool index; the agent spawns each GPU worker cold with
  CUDA_VISIBLE_DEVICES naming this node's ids, and its host workers see
  no GPU (CUDA_VISIBLE_DEVICES=""). A GPU worker's exit reaches the
  conductor only in a heartbeat, which is what returns its GPUs.
- Flags: the agent installs the head's resolved flag table from
  `session_info` (no environment variable carries one), and its workers
  get it through the spawn.
- The maintenance-event file is an argument (`maintenance_event=`,
  `--maintenance-event`), off by default.
- No chaos hook in the heartbeat (it waits for the chaos monkey, ROADMAP
  Queue 1 item 3).
- Only a daemon agent (`main`) ends its process when the cluster is
  gone or the conductor stops it; an agent built in a library process
  stops its threads and workers and leaves the process running.

Reference: src/ray/raylet/node_manager.h:125 (per-node daemon owning the
WorkerPool), src/ray/gcs/gcs_server/gcs_health_check_manager.cc (the
health channel this replaces with push heartbeats).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ids import NodeID
from .rpc import ReconnectingClient, RpcServer
from .worker_spawn import (ENV_GPU_INDICES, spawn_worker_process,
                           stop_fork_server, write_system_config)


def _heartbeat_period() -> float:
    from .config import config

    return config.node_heartbeat


class NodeAgentHandler:
    """RPC handler — conductor-facing surface of one worker host."""

    def __init__(self, node_id: str, conductor_address: Tuple[str, int],
                 session_dir: str, gpu_ids: Sequence[str] = (),
                 worker_env: Optional[Dict[str, str]] = None,
                 on_stop=None):
        self.node_id = node_id
        self.conductor_address = tuple(conductor_address)
        self.session_dir = session_dir
        self.gpu_ids = [str(g) for g in gpu_ids]
        # the node's own template and flag-table file in the session dir
        self.tag = node_id[:12]
        self.worker_env = {"CUDA_VISIBLE_DEVICES": ""}
        self.worker_env.update(worker_env or {})
        self._on_stop = on_stop
        self._procs: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def spawn_worker(self, worker_id: str,
                     gpus: Optional[List[int]] = None) -> bool:
        """Start a worker; `gpus` (pool indices of this node's GPUs)
        makes it a GPU worker, spawned cold and bound to them."""
        env_extra = None
        if gpus:
            bad = [g for g in gpus if not 0 <= int(g) < len(self.gpu_ids)]
            if bad:
                raise ValueError(f"node {self.tag} has {len(self.gpu_ids)} "
                                 f"GPUs; asked to bind {bad}")
            env_extra = {
                "CUDA_VISIBLE_DEVICES": ",".join(self.gpu_ids[int(g)]
                                                 for g in gpus),
                ENV_GPU_INDICES: ",".join(str(int(g)) for g in gpus)}
        proc = spawn_worker_process(
            worker_id, self.conductor_address, self.session_dir,
            worker_env=self.worker_env, env_extra=env_extra,
            node_id=self.node_id, cold=bool(gpus), tag=self.tag)
        with self._lock:
            self._procs[worker_id] = proc
        return True

    def reap_dead(self) -> List[str]:
        """Worker ids whose processes exited since the last call."""
        dead = []
        with self._lock:
            for wid, proc in list(self._procs.items()):
                if proc.poll() is not None:
                    dead.append(wid)
                    del self._procs[wid]
        return dead

    def oom_tick(self, mon) -> Optional[Tuple[str, str]]:
        """One memory-monitor tick over this host's workers. The agent
        has no task/actor state, so the victim is purely highest-RSS."""
        with self._lock:
            cands = [(wid, p.pid, "BUSY")
                     for wid, p in self._procs.items() if p.poll() is None]
        return mon.kill_greediest(cands, self.tag)

    def config_snapshot(self) -> Dict[str, Any]:
        """The flag table in force in this agent."""
        from .config import config

        return config.snapshot()

    def ping(self) -> str:
        return "pong"

    def stop_node(self) -> bool:
        """The conductor is stopping: end this node's workers, then the
        agent."""
        self._shutdown_workers()
        if self._on_stop is not None:
            threading.Thread(target=self._on_stop, daemon=True).start()
        return True

    def _shutdown_workers(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 3.0
        for p in procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 — wedged: kill it
                try:
                    p.kill()
                    p.wait(2.0)
                except Exception:  # noqa: BLE001 — already gone
                    pass
        stop_fork_server(self.session_dir, self.tag)


class NodeAgent:
    """Runs a NodeAgentHandler on an RpcServer, registers with the
    conductor, and heartbeats (carrying dead-worker reports)."""

    def __init__(self, conductor_address: Tuple[str, int],
                 resources: Dict[str, float],
                 session_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 worker_env: Optional[Dict[str, str]] = None,
                 node_id: Optional[str] = None,
                 gpu_ids: Optional[Sequence[str]] = None,
                 maintenance_event: Optional[str] = None):
        """`gpu_ids`: this node's id of each GPU `resources["GPU"]`
        counts (default 0..n-1). `maintenance_event`: a file whose
        appearance announces this host's preemption (None: no
        channel)."""
        from .config import config

        self.node_id = node_id or NodeID().hex()
        self.resources = dict(resources)
        n_gpus = int(self.resources.get("GPU", 0))
        self.gpu_ids = [str(g) for g in (gpu_ids if gpu_ids is not None
                                         else range(n_gpus))][:n_gpus]
        if len(self.gpu_ids) < n_gpus:
            raise ValueError(f"{n_gpus} GPUs counted but only "
                             f"{len(self.gpu_ids)} GPU ids given")
        self.conductor_address = tuple(conductor_address)
        self._conductor = ReconnectingClient(self.conductor_address)
        info = self._conductor.call("session_info", timeout=10.0)
        # the head's flags hold here and, through the spawn, in this
        # node's workers
        config.load(info["system_config"])
        if session_dir is None:
            session_dir = info["session_dir"]
        os.makedirs(session_dir, exist_ok=True)
        self.session_dir = session_dir
        self._conductor_machine = info.get("machine")
        self._maintenance_event = maintenance_event
        self._daemon = False  # set by main(): may end its process
        self._stopped = threading.Event()
        self._done = threading.Event()  # stop() finished
        self.handler = NodeAgentHandler(self.node_id,
                                        self.conductor_address,
                                        session_dir, self.gpu_ids,
                                        worker_env=worker_env,
                                        on_stop=self.stop)
        self.server = RpcServer(self.handler, host=host, port=port,
                                max_workers=8)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="node-agent-heartbeat",
            daemon=True)
        # OOM causes awaiting a successful heartbeat ack — a dropped
        # heartbeat (or conductor restart) must not lose the diagnosis
        self._pending_causes: Dict[str, str] = {}
        self._causes_lock = threading.Lock()
        self._mem_thread = threading.Thread(
            target=self._memory_loop, name="node-agent-memmon", daemon=True)
        self._preemption_watcher = None
        self._log_monitor = None

    def start(self) -> "NodeAgent":
        write_system_config(self.session_dir, self.handler.tag)
        self.server.start()
        self._register(timeout=10.0)
        self._hb_thread.start()
        self._mem_thread.start()
        if self._maintenance_event:
            # an upcoming host reclaim becomes a conductor broadcast —
            # "checkpoint now, grace N seconds" — before the platform
            # starts killing processes
            from ..resilience.preemption import PreemptionWatcher

            self._preemption_watcher = PreemptionWatcher(
                self.notify_preemption,
                spec=self._maintenance_event).start()
        # tail THIS host's worker logs into the worker_logs channel — but
        # only when the head is another machine: on a shared host the
        # conductor's own tailer covers the shared session dir
        from .worker import machine_id

        if self._conductor_machine != machine_id():
            from .log_monitor import LogMonitor

            self._log_monitor = LogMonitor(
                os.path.join(self.session_dir, "logs"),
                lambda batch: self._conductor.notify(
                    "publish", "worker_logs", batch),
                node_label=self.handler.tag).start()
        return self

    def _register(self, timeout: float) -> None:
        self._conductor.call("register_node", self.node_id, self.resources,
                             self.server.address, self.gpu_ids,
                             timeout=timeout)

    def _memory_loop(self) -> None:
        """Memory monitor at its OWN cadence (memory_monitor_refresh_ms)
        — the heartbeat period may be seconds, far too slow to beat the
        kernel OOM killer to a runaway task."""
        from .config import config
        from .memory_monitor import MemoryMonitor

        mon = None
        while not self._stopped.is_set():
            ms = config.memory_monitor_refresh_ms
            if ms <= 0:
                self._stopped.wait(1.0)
                continue
            self._stopped.wait(ms / 1000.0)
            if mon is None or mon.threshold != config.memory_usage_threshold:
                mon = MemoryMonitor(config.memory_usage_threshold)
            try:
                res = self.handler.oom_tick(mon)
            except Exception:  # noqa: BLE001 — monitor must keep running
                continue
            if res is not None:
                with self._causes_lock:
                    self._pending_causes[res[0]] = res[1]

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def notify_preemption(self, event) -> None:
        """Report this host's preemption (maintenance event / SIGTERM)
        to the conductor; it drains the host and broadcasts the
        checkpoint-now signal."""
        try:
            self._conductor.call("report_preemption", self.node_id, None,
                                 event.grace_s, event.reason, timeout=5.0)
        except Exception:  # noqa: BLE001 — conductor mid-restart: the
            pass           # next heartbeat re-establishes contact

    def _heartbeat_loop(self) -> None:
        from .config import config

        grace = config.node_orphan_grace
        last_ok = time.monotonic()
        pending_dead: List[str] = []
        while not self._stopped.wait(_heartbeat_period()):
            with self._causes_lock:
                causes = dict(self._pending_causes)
            pending_dead.extend(self.handler.reap_dead())
            try:
                known = self._conductor.call("node_heartbeat", self.node_id,
                                             pending_dead, causes,
                                             timeout=5.0)
                if not known:
                    # conductor restarted and lost us: register again
                    # (keep the causes/dead lists for the next heartbeat)
                    self._register(timeout=5.0)
                else:
                    pending_dead.clear()
                    with self._causes_lock:
                        for wid in causes:
                            self._pending_causes.pop(wid, None)
                last_ok = time.monotonic()
            except Exception:  # noqa: BLE001 — conductor unreachable
                # tolerate a brief outage (conductor restart); a sustained
                # one means the cluster is gone -> shut this host down
                if time.monotonic() - last_ok > grace:
                    self.stop()
                    return

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        for part in (self._preemption_watcher, self._log_monitor):
            if part is not None:
                part.stop()
        self.handler._shutdown_workers()
        try:
            # force: this host is leaving whether or not leases are live;
            # the conductor frees them and restarts actors elsewhere
            self._conductor.call("deregister_node", self.node_id, True,
                                 timeout=2.0)
        except Exception:  # noqa: BLE001 — conductor gone
            pass
        self.server.stop()
        self._conductor.close()
        self._done.set()
        if self._daemon:
            os._exit(0)


def node_gpus(num_gpus: Optional[int]) -> Tuple[int, List[str]]:
    """(count, ids) of this host's GPUs: `num_gpus` when given, else
    `torch.cuda.device_count()` (which honours CUDA_VISIBLE_DEVICES);
    the ids are CUDA_VISIBLE_DEVICES' entries, else 0..n-1."""
    from .. import _detect_gpus, _visible_gpu_ids

    n = _detect_gpus() if num_gpus is None else int(num_gpus)
    return n, _visible_gpu_ids(n)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="join a ray_tpu_torch cluster as a worker host")
    ap.add_argument("--address", required=True, help="head host:port")
    ap.add_argument("--num-cpus", type=float,
                    default=float(os.cpu_count() or 1))
    ap.add_argument("--num-gpus", type=int, default=None,
                    help="GPUs to count (default: the ones this process "
                         "sees)")
    ap.add_argument("--resources", default=None,
                    help='extra resources as JSON, e.g. \'{"widget": 2}\'')
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--node-id", default=None,
                    help="pre-assigned node id")
    ap.add_argument("--maintenance-event", default=None,
                    help="a file whose appearance announces this host's "
                         "preemption")
    args = ap.parse_args(argv)
    host, port = args.address.rsplit(":", 1)
    resources = {"CPU": args.num_cpus}
    if args.resources:
        resources.update(json.loads(args.resources))
    n_gpus, gpu_ids = node_gpus(resources.pop("GPU", args.num_gpus))
    resources["GPU"] = float(n_gpus)
    agent = NodeAgent((host, int(port)), resources, node_id=args.node_id,
                      gpu_ids=gpu_ids,
                      maintenance_event=args.maintenance_event)
    agent._daemon = True
    agent.start()
    # daemon main only (a library must not hijack signals): SIGTERM —
    # how platforms reclaim a machine — becomes a preemption broadcast
    from ..resilience.preemption import install_sigterm_notifier

    install_sigterm_notifier(agent.notify_preemption)
    print(f"node agent {agent.node_id} on {agent.address[0]}:"
          f"{agent.address[1]} joined {args.address} with "
          f"{n_gpus} GPU(s) {gpu_ids}", flush=True)
    try:
        while not agent._done.wait(1.0):
            pass
    except KeyboardInterrupt:
        agent.stop()


if __name__ == "__main__":
    main()
