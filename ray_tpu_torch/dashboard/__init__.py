"""Web dashboard: cluster state over HTTP + a single-file SPA (the port
of the JAX package's dashboard/).

Replaces the reference's `dashboard/` subsystem (aiohttp head + per-node
agents + React SPA, dashboard/dashboard.py, dashboard/client/) with one
HTTP server beside the conductor. There are no per-node dashboard agents
to aggregate: the conductor is already the single authority for
nodes/workers/actors/jobs, and per-worker object stats are one RPC away.
Where the JAX package serves on aiohttp, the port serves on the standard
library's HTTP/1.1 layer shared with the gateway and the serve proxy
(serve/_http.py): GET only (no HEAD), request bodies by
`Content-Length`, an `X-Request-Id` on every response.

Routes:
  /                      the SPA (ray_tpu_torch/dashboard/index.html)
  /api/summary           cluster overview (nodes + resources + counts)
  /api/nodes|workers|actors|placement_groups|jobs
  /api/objects           per-process object store stats (fan-out)
  /api/tasks             task-name summary table
  /api/timeline          chrome-trace JSON of task events
  /api/logs              the newest worker output lines
  /api/metrics           Prometheus exposition (text)
  /api/serve             Serve apps/deployments/proxies (controller's
                         KV-mirrored status)
  /api/train             gang training telemetry (flight recorder)
  /api/autoscaler        the node autoscaler's KV status mirror + live
                         pending demand (`[]` until the conductor has
                         `get_pending_demand`, ROADMAP Queue 1 item 8)
  /api/resilience        recovery subsystem: quarantined/draining hosts,
                         failure scores, restart/preemption counters
  /api/weights           live weight fabric: committed/pending versions
  /api/kvcache           paged KV prefix cache + recent events
  /api/speculation       speculative decoding + spec_* markers
  /api/pipeline          MPMD pipelines + recent events
  /api/online            online learning loop + recent events
  /api/disagg            disaggregated serving + recent events
  /api/kvplane           global KV plane + recent events
  /api/autoscale         serving autoscaler + recent events
  /api/servefault        serving-plane fault tolerance + recent events
  /api/lora              multi-tenant LoRA serving + recent events
  /api/gateway           HTTP front door + recent events
  /api/requesttrace      per-request flight recorder + recent events
  /api/rpc               control-plane dispatch stats per RPC method
  /api/actors/{id}       actor drill-down (record, worker, recent task
                         events, store stats)
  /api/oracle            501: the step-time oracle and its conductor
                         surface are not ported (ROADMAP Queue 1 item 7)

A query that fails answers 503 with {"error": ...}. The blocking
conductor and worker calls run on the server's own executor threads.
This module imports no torch.
"""
from __future__ import annotations

import asyncio
import json
import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from .._private.rpc import ClientPool, ReconnectingClient
from ..serve._http import (HttpServer, _json_response, _Response,
                           _text_response)

DEFAULT_DASHBOARD_PORT = 8265
ORACLE_NOT_PORTED = (
    "501: the step-time oracle (observability/roofline.py and the "
    "conductor's oracle surface) is not ported yet: ROADMAP Queue 1 item 7 "
    "(the roofline)")
_INDEX = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "index.html")
_SERVER = "ray_tpu_torch-dashboard"
_MAX_BODY = 1 << 20  # GET routes only: a body is read and ignored


class _ClusterData:
    """Blocking conductor/worker queries (run on the server's executor)."""

    def __init__(self, conductor_address: Tuple[str, int]):
        self.conductor = ReconnectingClient(tuple(conductor_address))
        self.pool = ClientPool()

    def close(self) -> None:
        self.conductor.close()
        self.pool.close_all()

    def summary(self) -> Dict[str, Any]:
        c = self.conductor
        return {
            "timestamp": time.time(),
            "address": list(self.conductor.address),
            "nodes": c.call("nodes", timeout=5.0),
            "resources_total": c.call("cluster_resources", timeout=5.0),
            "resources_available": c.call("available_resources", timeout=5.0),
            "num_workers": len(c.call("list_workers", timeout=5.0)),
            "num_actors": len(c.call("list_actors", timeout=5.0)),
        }

    def simple(self, method: str) -> Any:
        return self.conductor.call(method, timeout=10.0)

    def simple_args(self, method: str, *args) -> Any:
        return self.conductor.call(method, *args, timeout=10.0)

    def objects(self) -> List[Dict[str, Any]]:
        out = []
        for rec in self.conductor.call("list_workers", timeout=5.0):
            addr = rec.get("address")
            if not addr or rec.get("state") == "DEAD":
                continue
            try:
                out.append(self.pool.get(tuple(addr)).call("store_stats",
                                                           timeout=3.0))
            except Exception:  # noqa: BLE001 — worker mid-restart
                pass
        return out

    def tasks_summary(self) -> List[Dict[str, Any]]:
        events = self.conductor.call("get_task_events", 10_000, timeout=10.0)
        groups: Dict[str, Dict[str, Any]] = defaultdict(
            lambda: {"count": 0, "failed": 0, "total_s": 0.0})
        for ev in events:
            g = groups[ev["name"]]
            g["count"] += 1
            g["failed"] += 1 if ev.get("status") == "FAILED" else 0
            g["total_s"] += max(0.0, ev["end"] - ev["start"])
        return [dict(name=k, mean_s=v["total_s"] / max(1, v["count"]), **v)
                for k, v in sorted(groups.items())]

    def timeline(self) -> List[Dict[str, Any]]:
        from ..observability.timeline import task_trace_events

        events = self.conductor.call("get_task_events", 10_000, timeout=10.0)
        return task_trace_events(events)

    def metrics_text(self) -> str:
        from ..util.state import _render_prometheus

        return _render_prometheus(self.conductor.call("get_metrics",
                                                      timeout=5.0))

    def train_progress(self) -> Dict[str, Any]:
        """Flight-recorder gang telemetry (per-rank step stats, skew,
        stragglers) aggregated by the conductor; int rank keys become
        strings in the JSON."""
        return self.conductor.call("get_train_progress", timeout=10.0)

    def serve_status(self) -> Dict[str, Any]:
        """Serve apps/deployments/proxies, mirrored into the conductor
        KV by the Serve controller's reconcile loop."""
        status = self.conductor.call("kv_get", "serve:status", "serve",
                                     timeout=5.0)
        return status or {"applications": {}, "proxies": {}}

    def autoscaler_status(self) -> Dict[str, Any]:
        """Autoscaler reconcile state (KV mirror) + live pending demand
        from the conductor — the `ray status` analog. The port's
        conductor has no `get_pending_demand` yet (ROADMAP Queue 1 item
        8), so `live_demand` is [] as for JAX's older conductor."""
        raw = self.conductor.call("kv_get", b"autoscaler:status",
                                  "autoscaler", timeout=5.0)
        status = json.loads(raw.decode()) if raw else {}
        try:
            status["live_demand"] = self.conductor.call(
                "get_pending_demand", timeout=5.0)
        except Exception:  # noqa: BLE001 — a conductor without it
            status["live_demand"] = []
        return status

    def _with_events(self, status: str, events: str,
                     limit: int = 100) -> Dict[str, Any]:
        """A subsystem's aggregate + its recent event tail (one payload,
        so the SPA's panel needs a single fetch)."""
        out = self.conductor.call(status, timeout=10.0)
        try:
            out["events"] = self.conductor.call(events, limit, timeout=5.0)
        except Exception:  # noqa: BLE001 — the tail is best effort
            out["events"] = []
        return out

    def kvcache(self) -> Dict[str, Any]:
        return self._with_events("get_kvcache_stats", "get_kvcache_events")

    def speculation(self) -> Dict[str, Any]:
        """Speculation aggregate + the kvcache lane's spec_accept /
        spec_reject marker slice."""
        out = self.conductor.call("get_speculation_stats", timeout=10.0)
        try:
            events = self.conductor.call("get_kvcache_events", 10_000,
                                         timeout=5.0)
            out["events"] = [e for e in events if str(
                e.get("kind", "")).startswith("spec_")][-100:]
        except Exception:  # noqa: BLE001 — the tail is best effort
            out["events"] = []
        return out

    def pipeline(self) -> Dict[str, Any]:
        return self._with_events("get_pipeline_status", "get_pipeline_events")

    def online(self) -> Dict[str, Any]:
        return self._with_events("get_online_status", "get_online_events")

    def disagg(self) -> Dict[str, Any]:
        return self._with_events("get_disagg_status", "get_disagg_events")

    def kvplane(self) -> Dict[str, Any]:
        return self._with_events("get_kvplane_status", "get_kvplane_events")

    def autoscale(self) -> Dict[str, Any]:
        return self._with_events("get_autoscale_status",
                                 "get_autoscale_events")

    def servefault(self) -> Dict[str, Any]:
        return self._with_events("get_servefault_status",
                                 "get_servefault_events")

    def lora(self) -> Dict[str, Any]:
        return self._with_events("get_lora_status", "get_lora_events")

    def gateway(self) -> Dict[str, Any]:
        return self._with_events("get_gateway_status", "get_gateway_events")

    def requesttrace(self) -> Dict[str, Any]:
        return self._with_events("get_requesttrace_status",
                                 "get_requesttrace_events")

    def actor_detail(self, actor_id: str) -> Dict[str, Any]:
        """One actor's record + its worker + its recent task events —
        the actors-table drill-down."""
        actors = self.conductor.call("list_actors", timeout=5.0)
        rec = next((a for a in actors if a.get("actor_id") == actor_id),
                   None)
        if rec is None:
            return {"error": f"no actor {actor_id!r}"}
        addr = tuple(rec["address"]) if rec.get("address") else None
        if addr is None:  # PENDING/DEAD actor: nothing to join against
            return {"actor": rec, "worker": None, "recent_tasks": [],
                    "store": None}
        workers = self.conductor.call("list_workers", timeout=5.0)
        worker = next((w for w in workers if w.get("address")
                       and tuple(w["address"]) == addr), None)
        events = self.conductor.call("get_task_events", 10_000,
                                     timeout=10.0)
        mine = [ev for ev in events if ev.get("worker")
                and tuple(ev["worker"]) == addr][-100:]
        store = None
        if worker is not None and worker.get("state") != "DEAD":
            try:
                store = self.pool.get(addr).call("store_stats", timeout=3.0)
            except Exception:  # noqa: BLE001 — worker mid-restart
                pass
        return {"actor": rec, "worker": worker, "recent_tasks": mine,
                "store": store}


class DashboardServer:
    """The dashboard's HTTP server on a thread and event loop of its own
    (serve/_http.py) — works beside a blocking conductor (in-process
    head) or standalone via `python -m ray_tpu_torch dashboard`.
    `port=0` binds a free port; `url` reports the bound one. `stop()`
    closes the socket and every connection, joins the server's thread
    and executor, and closes the conductor and worker clients."""

    def __init__(self, conductor_address: Tuple[str, int],
                 host: str = "127.0.0.1",
                 port: int = DEFAULT_DASHBOARD_PORT):
        self.data = _ClusterData(tuple(conductor_address))
        self.host, self.port = host, port
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="dashboard-query")
        self._http = HttpServer(self._dispatch, host, port,
                                name="dashboard-http", server=_SERVER,
                                label="dashboard",
                                max_body=lambda: _MAX_BODY)
        self._routes = self._make_routes()

    # ------------------------------------------------------------ routes

    def _make_routes(self) -> Dict[str, Callable[[], Any]]:
        """GET path -> a blocking query whose result is the JSON body."""
        d = self.data
        routes: Dict[str, Callable[[], Any]] = {
            "/api/summary": d.summary,
            "/api/objects": d.objects,
            "/api/tasks": d.tasks_summary,
            "/api/timeline": d.timeline,
            "/api/logs": lambda: d.simple_args("get_recent_logs", 500),
            "/api/serve": d.serve_status,
            "/api/train": d.train_progress,
            "/api/autoscaler": d.autoscaler_status,
            "/api/resilience": lambda: d.simple("get_resilience_status"),
            "/api/weights": lambda: d.simple("get_weight_versions"),
            "/api/rpc": lambda: d.simple("get_rpc_stats"),
        }
        for name, method in [("nodes", "nodes"),
                             ("workers", "list_workers"),
                             ("actors", "list_actors"),
                             ("placement_groups", "list_placement_groups"),
                             ("jobs", "list_jobs")]:
            routes[f"/api/{name}"] = lambda m=method: d.simple(m)
        for name in ("kvcache", "speculation", "pipeline", "online",
                     "disagg", "kvplane", "autoscale", "servefault", "lora",
                     "gateway", "requesttrace"):
            routes[f"/api/{name}"] = getattr(d, name)
        return routes

    async def _call(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, fn, *args)

    async def _json(self, fn, *args) -> _Response:
        try:
            return _json_response(await self._call(fn, *args))
        except Exception as e:  # noqa: BLE001 — surface, don't 500-html
            return _json_response({"error": str(e)}, status=503)

    async def _dispatch(self, request) -> _Response:
        path = request.path
        if request.method != "GET":
            return _text_response("405: Method Not Allowed", status=405,
                                  headers={"Allow": "GET"})
        if path == "/":
            with open(_INDEX, "rb") as f:
                return _Response(f.read(), content_type="text/html")
        if path == "/api/metrics":
            try:
                return _text_response(await self._call(
                    self.data.metrics_text))
            except Exception as e:  # noqa: BLE001
                return _json_response({"error": str(e)}, status=503)
        if path == "/api/oracle":
            return _text_response(ORACLE_NOT_PORTED, status=501)
        fn = self._routes.get(path)
        if fn is not None:
            return await self._json(fn)
        prefix = "/api/actors/"
        if path.startswith(prefix) and "/" not in path[len(prefix):] \
                and path != prefix:
            return await self._json(self.data.actor_detail,
                                    path[len(prefix):])
        return _text_response("404: Not Found", status=404)

    # ------------------------------------------------------------ lifecycle

    def start(self, timeout: float = 10.0) -> "DashboardServer":
        self._http.start()
        self.port = self._http.wait_ready(timeout, "dashboard")
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._http.stop()
        self._pool.shutdown(wait=True, cancel_futures=True)
        self.data.close()


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="ray_tpu_torch web dashboard")
    ap.add_argument("--address", required=True, help="conductor host:port")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_DASHBOARD_PORT)
    args = ap.parse_args(argv)
    host, port = args.address.rsplit(":", 1)
    srv = DashboardServer((host, int(port)), host=args.host,
                          port=args.port).start()
    print(f"dashboard at {srv.url}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
