"""ServeController (the port of ray_tpu/serve/controller.py) — the
reference's python/ray/serve/_private/controller.py:85 (ServeController)
+ deployment_state.py:1225,2447 (DeploymentState/DeploymentStateManager
reconciliation) + autoscaling_policy.py (queue-length autoscaling) +
long_poll.py (config push modeled as a version counter routers poll).

One named actor owns all Serve state; a background thread reconciles
target vs running replicas, health-checks them (a dead replica is
replaced), and autoscales through the shared ``ScalingPolicy``
(serve/autoscale.py). ``proxy_location="EveryNode"`` runs one proxy on
every alive node, pinned by ``NodeAffinitySchedulingStrategy``. A
deployment's ``ray_actor_options`` are its replicas' actor options:
``{"num_gpus": 1}`` gives a replica a whole GPU's lease.

Where the port differs: no gRPC ingress (``grpc_port`` must be None;
``get_grpc_address`` answers disabled)."""
from __future__ import annotations

import math
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .config import AutoscalingConfig, DeploymentConfig
from .handle import CONTROLLER_NAME  # noqa: F401 — canonical name lives here

PROXY_NAME = "SERVE_PROXY"


class _DeploymentState:
    def __init__(self, app_name: str, name: str, serialized_callable: bytes,
                 init_args: bytes, config: DeploymentConfig):
        self.app_name = app_name
        self.name = name
        self.serialized_callable = serialized_callable
        self.init_args = init_args
        self.config = config
        self.target_num_replicas = config.num_replicas
        self.scaling_policy = None  # autoscale.ScalingPolicy, lazy
        if config.autoscaling_config is not None:
            from .autoscale import ScalingPolicy

            cfg = config.autoscaling_config
            self.target_num_replicas = max(cfg.min_replicas, 1)
            # the SHARED hysteresis engine (serve/autoscale.py) — the
            # same persistence gates the disagg tier loop uses;
            # cooldown 0 keeps the reference controller semantics
            self.scaling_policy = ScalingPolicy(
                cfg.min_replicas, cfg.max_replicas,
                up_delay_s=cfg.upscale_delay_s,
                down_delay_s=cfg.downscale_delay_s, cooldown_s=0.0)
        self.replicas: List[Tuple[str, Any]] = []  # (tag, ActorHandle)
        self.last_health_check = 0.0
        self.status = "DEPLOYING"
        # handle_id -> (total inflight from that handle, monotonic ts)
        self.handle_metrics: Dict[str, Tuple[float, float]] = {}
        # replica_tag -> last get_metrics() snapshot (collected on the
        # health-check cadence; feeds `serve status` and /api/serve)
        self.replica_metrics: Dict[str, Dict[str, Any]] = {}

    def to_status(self) -> Dict[str, Any]:
        mets = list(self.replica_metrics.values())
        # worst-replica recent p99s (merging percentiles across windows
        # would be a lie; the max is the honest deployment-level number
        # beside the cumulative counters)
        recent = {}
        for key in ("ttft_ms", "latency_ms"):
            vals = [m["recent"][key]["p99"] for m in mets
                    if (m.get("recent") or {}).get(key, {}).get("n")]
            if vals:
                recent[f"{key[:-3]}_p99_ms"] = round(max(vals), 3)
        return {"name": self.name, "status": self.status,
                "target_num_replicas": self.target_num_replicas,
                "replicas": [tag for tag, _ in self.replicas],
                "metrics": {
                    "inflight": sum(m.get("inflight", 0) for m in mets),
                    "num_requests": sum(m.get("num_requests", 0)
                                        for m in mets),
                    "num_errors": sum(m.get("num_errors", 0)
                                      for m in mets),
                    "recent": recent,
                    "per_replica": dict(self.replica_metrics)}}


class ServeController:
    """Reference controller.py:85 — singleton detached actor."""

    def __init__(self, http_host: str = "127.0.0.1", http_port: int = 8000,
                 grpc_port: Optional[int] = None,
                 proxy_location: str = "EveryNode"):
        if grpc_port is not None:
            from .config import GRPC_NOT_PORTED

            raise NotImplementedError(GRPC_NOT_PORTED)
        self._apps: Dict[str, Dict[str, Any]] = {}
        self._deployments: Dict[Tuple[str, str], _DeploymentState] = {}
        self._version = 0
        self._lock = threading.RLock()
        self._shutting_down = False
        self._http_host = http_host
        self._http_port = http_port
        self._proxy = None  # the head-node proxy (primary address)
        self._proxy_addr: Optional[Tuple[str, int]] = None
        self._proxy_location = proxy_location
        # per-node proxy fleet (reference proxy_state.py ProxyStateManager:
        # one ProxyActor per alive node, reconciled with cluster topology)
        self._proxies: Dict[str, Any] = {}
        self._proxy_addrs: Dict[str, Tuple[str, int]] = {}
        self._proxy_pending: set = set()
        self._last_topology_check = 0.0
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile")
        self._reconcile_thread.start()

    # -- deploy / delete ----------------------------------------------------
    def deploy_application(self, app_config: Dict[str, Any]) -> None:
        """app_config: {name, route_prefix, ingress,
        deployments: [{name, serialized_callable, init_args, config}]}."""
        app = app_config["name"]
        # Tear down any previous version OUTSIDE the lock: replica drain can
        # take graceful_shutdown_timeout_s per replica and must not block
        # get_serve_status/poll_update/record_handle_metrics.
        self.delete_application(app)
        with self._lock:
            self._apps[app] = {
                "route_prefix": app_config.get("route_prefix", "/"),
                "ingress": app_config["ingress"],
                "deployments": [d["name"]
                                for d in app_config["deployments"]],
            }
            for d in app_config["deployments"]:
                cfg = d["config"]
                cfg.validate()
                self._deployments[(app, d["name"])] = _DeploymentState(
                    app, d["name"], d["serialized_callable"], d["init_args"],
                    cfg)
            self._version += 1

    def delete_application(self, app: str) -> None:
        with self._lock:
            if app not in self._apps:
                return
            doomed = [k for k in self._deployments if k[0] == app]
            states = [self._deployments.pop(k) for k in doomed]
            del self._apps[app]
            self._version += 1
        for st in states:
            for tag, handle in st.replicas:
                self._stop_replica(handle, st.config)

    def graceful_shutdown(self) -> None:
        with self._lock:
            self._shutting_down = True
            states = list(self._deployments.values())
            self._deployments.clear()
            self._apps.clear()
            self._version += 1
        import ray_tpu_torch as rt
        for st in states:
            for tag, handle in st.replicas:
                self._stop_replica(handle, st.config)
        with self._lock:
            doomed_proxies = list(self._proxies.values())
            self._proxies.clear()
            self._proxy_addrs.clear()
            self._proxy = None
        # join the reconcile thread BEFORE clearing the KV mirror: an
        # in-flight _publish_status must not re-publish ghost status
        # after the delete (nothing would ever overwrite it again)
        self._reconcile_thread.join(timeout=10.0)
        try:
            from .._private import worker as worker_mod

            worker_mod.global_worker.conductor.notify(
                "kv_del", "serve:status", "serve")
        except Exception:  # noqa: BLE001 — conductor may be gone too
            pass
        for actor in doomed_proxies:
            try:
                rt.get(actor.graceful_shutdown.remote(), timeout=5.0)
                rt.kill(actor)
            except Exception:  # noqa: BLE001 — proxy may already be gone
                pass

    # -- introspection (state API / routers / proxy) ------------------------
    def get_replicas(self, app: str, deployment: str
                     ) -> Tuple[int, List[Tuple[str, Any]]]:
        with self._lock:
            st = self._deployments.get((app, deployment))
            if st is None:
                return self._version, []
            return self._version, list(st.replicas)

    def get_deployment_limits(self, app: str, deployment: str
                              ) -> Dict[str, Any]:
        """Admission-control knobs the router enforces client-side
        (fetched alongside the replica set on a version change)."""
        with self._lock:
            st = self._deployments.get((app, deployment))
            if st is None:
                return {}
            return {
                "max_ongoing_requests": st.config.max_ongoing_requests,
                "max_queued_requests": getattr(
                    st.config, "max_queued_requests", -1),
            }

    def get_route_table(self) -> Dict[str, Tuple[str, str]]:
        with self._lock:
            return {info["route_prefix"]: (app, info["ingress"])
                    for app, info in self._apps.items()}

    def poll_update(self, known_version: int, timeout_s: float = 10.0) -> int:
        """Long-poll — reference _private/long_poll.py LongPollHost."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._version != known_version:
                    return self._version
            time.sleep(0.05)
        return known_version

    def get_serve_status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "proxy": {"host": self._http_host, "port": self._http_port,
                          "ready": self._proxy_addr is not None},
                "proxies": {nid: list(addr) for nid, addr
                            in self._proxy_addrs.items()},
                "applications": {
                    app: {
                        "route_prefix": info["route_prefix"],
                        "ingress": info["ingress"],
                        "status": self._app_status(app),
                        "deployments": {
                            d: self._deployments[(app, d)].to_status()
                            for d in info["deployments"]},
                    } for app, info in self._apps.items()},
            }

    def _app_status(self, app: str) -> str:
        sts = [self._deployments[(app, d)].status
               for d in self._apps[app]["deployments"]]
        if all(s == "RUNNING" for s in sts):
            return "RUNNING"
        if any(s == "UNHEALTHY" for s in sts):
            return "UNHEALTHY"
        return "DEPLOYING"

    def get_proxy_address(self) -> Optional[Tuple[str, int]]:
        return self._proxy_addr

    def get_proxy_addresses(self) -> Dict[str, Tuple[str, int]]:
        """node_id -> bound (host, port) for every live proxy."""
        with self._lock:
            return dict(self._proxy_addrs)

    def get_grpc_address(self):
        """('disabled', None): the gRPC ingress is not ported, so
        clients return at once, as JAX's do when it is off."""
        return ("disabled", None)

    # -- reconciliation -----------------------------------------------------
    def _reconcile_loop(self):
        last_publish = 0.0
        while not self._shutting_down:
            try:
                self._ensure_proxy()
                self._reconcile_once()
                now = time.monotonic()
                if now - last_publish > 2.0:
                    last_publish = now
                    self._publish_status()
            except Exception:  # noqa: BLE001 — keep the loop alive
                import traceback
                traceback.print_exc()
            time.sleep(0.25)

    def _publish_status(self):
        """Mirror serve status into the conductor KV so out-of-band
        consumers (the dashboard) can render Serve apps without an
        actor-call path into this controller."""
        from .._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is None:
            return
        try:
            w.conductor.notify("kv_put", "serve:status",
                               self.get_serve_status(), True, "serve")
        except Exception:  # noqa: BLE001 — conductor briefly away
            pass

    def _ensure_proxy(self):
        """Reconcile the proxy fleet with cluster topology: one
        ProxyActor pinned to every alive node (EveryNode), each polling
        the same route table (reference proxy.py:1111 per-node proxies +
        proxy_state.py). The head node's proxy keeps the configured
        port; the rest bind ephemeral ports."""
        import ray_tpu_torch as rt
        from .._private import worker as worker_mod

        # topology changes are rare: poll it on its own slow cadence
        # instead of burdening every 0.25s reconcile tick with a
        # conductor RPC (and the proxy-ready wait below)
        now = time.monotonic()
        if self._proxies and now - self._last_topology_check < 5.0:
            return
        self._last_topology_check = now
        w = worker_mod.global_worker
        try:
            nodes = w.conductor.call("nodes", timeout=5.0)
        except Exception:  # noqa: BLE001 — conductor briefly unreachable
            return
        alive = [n for n in nodes if n["alive"]]
        head_id = next((n["node_id"] for n in alive if n.get("head")), None)
        if self._proxy_location != "EveryNode":
            alive = [n for n in alive if n.get("head")]
        for n in alive:
            nid = n["node_id"]
            with self._lock:
                if nid in self._proxies or nid in self._proxy_pending:
                    continue
                self._proxy_pending.add(nid)
            # proxy startup (actor create + ready wait) runs OFF the
            # reconcile thread: a slow node must not stall replica
            # health checks and autoscaling for every app
            threading.Thread(
                target=self._create_proxy,
                args=(nid, nid == head_id,
                      (n.get("address") or [None])[0]),
                daemon=True, name=f"serve-proxy-create-{nid[:8]}").start()
        alive_ids = {n["node_id"] for n in alive}
        with self._lock:
            dead = [(x, self._proxies.pop(x))
                    for x in list(self._proxies) if x not in alive_ids]
            for nid, _ in dead:
                self._proxy_addrs.pop(nid, None)
        for _, actor in dead:
            try:
                rt.kill(actor)
            except Exception:  # noqa: BLE001 — died with its node
                pass

    def _create_proxy(self, nid: str, is_head: bool,
                      node_host: Optional[str]) -> None:
        import ray_tpu_torch as rt
        from ..util.scheduling_strategies import \
            NodeAffinitySchedulingStrategy
        from .proxy import ProxyActor

        actor = None
        try:
            # non-head proxies bind wildcard (the head's configured host
            # may not exist on that machine) and advertise their node's
            # reachable address
            actor = rt.remote(ProxyActor).options(
                name=f"{PROXY_NAME}:{nid}", max_concurrency=32,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    nid, soft=False)).remote(
                self._http_host if is_head else "0.0.0.0",
                self._http_port if is_head else 0,
                None,
                None if is_head else (node_host or self._http_host))
            addr = tuple(rt.get(actor.ready.remote(), timeout=60.0))
        except Exception:  # noqa: BLE001 — node died mid-create; a
            actor = None   # later topology tick retries
        finally:
            with self._lock:
                self._proxy_pending.discard(nid)
                if actor is not None and not self._shutting_down:
                    self._proxies[nid] = actor
                    self._proxy_addrs[nid] = addr
                    if is_head:
                        self._proxy = actor
                        self._proxy_addr = addr
                        # the proxy skips busy ports — report the bound
                        self._http_host, self._http_port = addr
                    actor = None
        if actor is not None:  # shutdown raced the create: reap it
            try:
                rt.kill(actor)
            except Exception:  # noqa: BLE001
                pass

    def _reconcile_once(self):
        import ray_tpu_torch as rt
        with self._lock:
            states = list(self._deployments.values())
        for st in states:
            self._autoscale(st)
            with self._lock:
                live = list(st.replicas)
                want = st.target_num_replicas
            # health checks (reference deployment_state.py check_health path)
            now = time.monotonic()
            if now - st.last_health_check > st.config.health_check_period_s:
                st.last_health_check = now
                healthy = []
                replica_metrics: Dict[str, Any] = {}
                for tag, handle in live:
                    # piggyback data-plane telemetry on the health
                    # cadence: both calls are submitted BEFORE waiting
                    # so the pass still costs one round-trip wait per
                    # replica, not two (latency/TTFT live in Prometheus;
                    # these counters surface in `serve status`)
                    try:
                        health_ref = handle.check_health.remote()
                        metrics_ref = handle.get_metrics.remote()
                        rt.get(health_ref,
                                    timeout=st.config.health_check_timeout_s)
                        healthy.append((tag, handle))
                    except Exception:  # noqa: BLE001 — replica is dead
                        try:
                            rt.kill(handle)
                        except Exception:  # noqa: BLE001
                            pass
                        continue
                    try:
                        replica_metrics[tag] = rt.get(
                            metrics_ref,
                            timeout=st.config.health_check_timeout_s)
                    except Exception:  # noqa: BLE001 — busy replica:
                        pass           # keep the stale snapshot
                with self._lock:
                    st.replica_metrics = {
                        t: replica_metrics.get(t, st.replica_metrics.get(t))
                        for t, _ in healthy
                        if replica_metrics.get(t)
                        or st.replica_metrics.get(t)}
                if len(healthy) != len(live):
                    with self._lock:
                        st.replicas = healthy
                        self._version += 1
                    live = healthy
            # scale up
            while len(live) < want:
                tag = f"{st.app_name}#{st.name}#{uuid.uuid4().hex[:6]}"
                try:
                    handle = self._start_replica(st, tag)
                except Exception:  # noqa: BLE001 — e.g. no resources yet
                    st.status = "DEPLOYING"
                    break
                live.append((tag, handle))
                with self._lock:
                    st.replicas = list(live)
                    self._version += 1
            # scale down (newest first, like the reference's pending-first)
            removed = []
            while len(live) > want:
                removed.append(live.pop())
            if removed:
                with self._lock:
                    st.replicas = list(live)
                    self._version += 1
                for tag, handle in removed:
                    self._stop_replica(handle, st.config)
            st.status = "RUNNING" if len(live) >= want else "DEPLOYING"

    def _start_replica(self, st: _DeploymentState, tag: str):
        import ray_tpu_torch as rt
        from .replica import ReplicaActor
        opts = dict(st.config.ray_actor_options or {})
        opts.setdefault("max_concurrency", st.config.max_ongoing_requests)
        handle = rt.remote(ReplicaActor).options(**opts).remote(
            tag, st.name, st.app_name, st.serialized_callable, st.init_args,
            st.config.user_config)
        # Block until constructed so a broken __init__ surfaces here.
        rt.get(handle.check_health.remote(), timeout=60.0)
        return handle

    def _stop_replica(self, handle, config: DeploymentConfig):
        import ray_tpu_torch as rt
        try:
            rt.get(handle.prepare_for_shutdown.remote(
                config.graceful_shutdown_timeout_s),
                timeout=config.graceful_shutdown_timeout_s + 5.0)
        except Exception:  # noqa: BLE001 — force-kill below either way
            pass
        try:
            rt.kill(handle)
        except Exception:  # noqa: BLE001
            pass

    # -- autoscaling --------------------------------------------------------
    def record_handle_metrics(self, app: str, deployment: str,
                              handle_id: str, inflight: float) -> None:
        """Reference serve/_private/autoscaling_state.py — handles push their
        queued+ongoing counts; the controller aggregates across handles."""
        with self._lock:
            st = self._deployments.get((app, deployment))
            if st is not None:
                st.handle_metrics[handle_id] = (inflight, time.monotonic())

    _METRICS_STALE_S = 3.0

    def _autoscale(self, st: _DeploymentState):
        cfg: Optional[AutoscalingConfig] = st.config.autoscaling_config
        if cfg is None or st.scaling_policy is None:
            return  # NOTE: runs even with zero replicas, else a
        # min_replicas=0 deployment that scaled to zero could never wake up.
        now = time.monotonic()
        with self._lock:
            st.handle_metrics = {
                h: (v, ts) for h, (v, ts) in st.handle_metrics.items()
                if now - ts < self._METRICS_STALE_S}
            handle_total = sum(v for v, _ in st.handle_metrics.values())
            # replica-reported queue depth (collected on the health
            # cadence): a deployment whose handles stopped reporting —
            # or that is driven through the HTTP proxy's own handle —
            # still autoscales on what its replicas actually hold
            replica_total = sum(
                float(m.get("inflight", 0))
                for m in st.replica_metrics.values())
        total = max(handle_total, replica_total)
        desired = int(math.ceil(total / cfg.target_ongoing_requests))
        # the shared hysteresis engine (serve/autoscale.ScalingPolicy)
        # owns the clamp + persistence gates — one "don't flap" core
        # for both this controller and the disagg tier loop
        st.target_num_replicas = st.scaling_policy.decide(
            desired, st.target_num_replicas, now)
