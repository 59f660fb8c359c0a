"""The dashboard's and the CLI's checks that need a cluster, run by
`isolated.run_checks` in a driver process of their own
(tests/test_torch_dashboard.py makes each one a test case), and the
helpers the other checks' CLI and dashboard legs use: `cli_text` /
`cli_json` run `scripts/cli.main` in this process against this driver's
conductor with its standard output captured, `dashboard_json` starts a
`DashboardServer` on a free port, GETs one route over `http.client` and
stops it.

The `dashboard_*` checks twin tests/test_dashboard.py's five cases; the
`port_*` ones check what the JAX tests leave implicit: every route JAX's
dashboard registers answers here (JAX's list is the run's `inputs`),
`/api/oracle` answers 501 naming the roadmap item, and `stop()` leaves
no thread, socket or client behind.

This module imports no torch.
"""
from __future__ import annotations

import contextlib
import http.client
import io
import json
import threading
import time
from typing import Any, Dict, Tuple

import ray_tpu_torch as rt

from .cluster_checks import _conductor, _wait_until
from .runtime_checks import _worker

Got = Tuple[int, str, bytes]


# ------------------------------------------------------------- helpers

def cli_text(*argv: str) -> str:
    """`python -m ray_tpu_torch <argv> --address <this conductor>`, run
    in this process; its standard output."""
    from ..scripts import cli

    host, port = _worker().conductor_address
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([*argv, "--address", f"{host}:{port}"])
    return out.getvalue()


def cli_json(*argv: str) -> Any:
    return json.loads(cli_text(*argv, "--json"))


def http_get(url: str, path: str, timeout: float = 30.0) -> Got:
    """(status, content type without parameters, body) of one GET."""
    host, port = url.split("//", 1)[1].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        ctype = (r.getheader("Content-Type") or "").split(";")[0].strip()
        return r.status, ctype, r.read()
    finally:
        conn.close()


def dashboard_left(srv) -> Dict[str, Any]:
    """What a stopped dashboard left: its threads (the server's loop and
    its query executor), whether its port still accepts, and whether its
    conductor client is open."""
    import socket

    threads = sorted(t.name for t in threading.enumerate()
                     if t.name.startswith("dashboard"))
    try:
        with socket.create_connection((srv.host, srv.port), timeout=1.0):
            listening = True
    except OSError:
        listening = False
    return {"threads": threads, "listening": listening,
            "client_open": not srv.data.conductor._closed}


class _Dash:
    """A dashboard on a free port for the length of a `with`."""

    def __enter__(self):
        from ..dashboard import DashboardServer

        self.srv = DashboardServer(_worker().conductor_address,
                                   port=0).start()
        return self

    def get(self, path: str) -> Got:
        return http_get(self.srv.url, path)

    def json(self, path: str) -> Any:
        status, ctype, body = self.get(path)
        assert status == 200 and ctype == "application/json", \
            (path, status, body)
        return json.loads(body)

    def __exit__(self, *exc):
        self.srv.stop()


def dashboard_json(path: str) -> Any:
    """One route's JSON from a dashboard started for this call."""
    with _Dash() as d:
        return d.json(path)


# ------------------------------------------ tests/test_dashboard.py

def dashboard_spa_and_summary():
    with _Dash() as d:
        status, ctype, body = d.get("/")
        assert status == 200 and ctype == "text/html"
        assert b"ray_tpu" in body and b"/api/summary" in body
        status, ctype, body = d.get("/api/summary")
        assert status == 200 and ctype == "application/json"
        s = json.loads(body)
    assert s["resources_total"]["CPU"] == 2.0
    assert len(s["nodes"]) == 1 and s["nodes"][0]["alive"]


@rt.remote
def _work(x):
    return x * 2


class _A:
    def ping(self):
        return "pong"


def dashboard_entity_endpoints_reflect_cluster():
    assert rt.get([_work.remote(i) for i in range(4)],
                  timeout=60.0) == [0, 2, 4, 6]
    a = rt.remote(_A).options(name="dash-actor").remote()
    assert rt.get(a.ping.remote(), timeout=60.0) == "pong"
    with _Dash() as d:
        actors = d.json("/api/actors")
        assert any(r["name"] == "dash-actor" and r["state"] == "ALIVE"
                   for r in actors)
        assert len(d.json("/api/workers")) >= 1
        # task events reach the conductor in periodic batches — poll
        tasks: list = []

        def counted():
            tasks[:] = d.json("/api/tasks")
            return any(t["name"] == "_work" and t["count"] == 4
                       for t in tasks)

        _wait_until(counted, 15.0, lambda: f"/api/tasks {tasks}")
        assert isinstance(d.json("/api/objects"), list)
        trace = d.json("/api/timeline")
        assert any(ev["name"] == "_work" for ev in trace)
        status, ctype, _ = d.get("/api/metrics")
        assert status == 200 and ctype == "text/plain"


@rt.remote
def _chatty():
    print("DASHBOARD_LOG_MARKER")
    return 1


def dashboard_logs_endpoint_carries_worker_prints():
    assert rt.get(_chatty.remote(), timeout=60.0) == 1
    with _Dash() as d:
        entries: list = []

        def printed():
            entries[:] = d.json("/api/logs")
            return any("DASHBOARD_LOG_MARKER" in e.get("line", "")
                       for e in entries)

        _wait_until(printed, 10.0, "worker print never reached /api/logs")
        assert all({"worker", "line", "ts"} <= set(e) for e in entries)


class _Counter:
    def bump(self):
        return 1


def _hello(request):
    return "hi"


def dashboard_actor_drilldown_and_serve_view():
    """/api/actors/{id} aggregates record+worker+events; /api/serve
    mirrors the Serve controller's KV-published status."""
    from .. import serve

    a = rt.remote(_Counter).remote()
    rt.get(a.bump.remote(), timeout=60.0)
    w = _worker()
    w._flush_task_events()
    actor_id = _conductor().call("list_actors", timeout=5.0)[0]["actor_id"]
    with _Dash() as d:
        det = d.json(f"/api/actors/{actor_id}")
        assert det["actor"]["actor_id"] == actor_id
        assert det["worker"] is not None
        assert any(ev["name"].endswith(".bump")
                   for ev in det["recent_tasks"]), det["recent_tasks"]
        assert d.json("/api/actors/nope")["error"]
        # serve view: empty before serve starts
        assert d.json("/api/serve")["applications"] == {}
        serve.start()
        try:
            serve.run(serve.deployment(_hello).bind(), name="dash_app",
                      route_prefix="/h")
            apps: dict = {}

            def running():
                apps.clear()
                apps.update(d.json("/api/serve").get("applications", {}))
                return apps.get("dash_app", {}).get("status") == "RUNNING"

            _wait_until(running, 30.0, lambda: f"/api/serve {apps}")
            assert "_hello" in apps["dash_app"]["deployments"], apps
        finally:
            serve.shutdown()
        # shutdown clears the KV mirror: no ghost RUNNING apps
        _wait_until(lambda: d.json("/api/serve").get("applications") == {},
                    10.0, "serve apps outlived serve.shutdown()")


def dashboard_rpc_and_autoscaler_views():
    """/api/rpc serves per-method dispatch stats; /api/autoscaler serves
    the KV status mirror + live pending demand (empty-but-valid: no
    autoscaler runs, and the port's conductor has no pending demand
    yet)."""
    with _Dash() as d:
        stats = d.json("/api/rpc")
        assert isinstance(stats, dict) and stats
        method = next(iter(stats.values()))
        assert {"count", "mean_queue_ms", "mean_handler_ms"} <= set(method)
        a = d.json("/api/autoscaler")
        assert a["live_demand"] == []
        status, _, html = d.get("/")
        assert status == 200
        assert b"renderRpc" in html and b"renderAutoscaler" in html


def port_dashboard_oracle_not_ported():
    """/api/oracle answers 501 naming the roadmap item, and the SPA's
    oracle tab fetches that route."""
    with _Dash() as d:
        status, ctype, body = d.get("/api/oracle")
        assert status == 501 and ctype == "text/plain", (status, ctype)
        assert b"ROADMAP Queue 1 item 7" in body, body
        assert b'fetch("/api/oracle")' in d.get("/")[2]


def port_dashboard_every_jax_route_answers():
    """Every route of JAX's dashboard (the run's `inputs()["routes"]`)
    answers here: 200 with JSON (text for /api/metrics, HTML for /), the
    actor drill-down on a live actor, 501 for /api/oracle; a POST is
    405, an unknown path 404. Then stop() leaves no thread, socket or
    conductor client."""
    from ..dashboard import DashboardServer
    from .isolated import inputs

    a = rt.remote(_Counter).remote()
    rt.get(a.bump.remote(), timeout=60.0)
    routes = inputs()["routes"]
    srv = DashboardServer(_worker().conductor_address, port=0).start()
    answered = {}
    try:
        for route in routes:
            path = route.replace("{actor_id}", a.actor_id)
            status, ctype, body = http_get(srv.url, path)
            answered[route] = [status, ctype]
            if route == "/api/oracle":
                assert status == 501, (route, status)
                continue
            assert status == 200, (route, status, body[:300])
            want = {"/": "text/html", "/api/metrics": "text/plain"}.get(
                route, "application/json")
            assert ctype == want, (route, ctype)
            if want == "application/json":
                json.loads(body)
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30.0)
        conn.request("POST", "/api/summary", body=b"{}")
        r = conn.getresponse()
        assert r.status == 405 and r.getheader("X-Request-Id"), r.status
        r.read()
        conn.close()
        assert http_get(srv.url, "/api/no-such-route")[0] == 404
    finally:
        srv.stop()
    t0 = time.monotonic()
    left = dashboard_left(srv)
    assert left == {"threads": [], "listening": False,
                    "client_open": False}, left
    return {"routes": len(answered), "left_checked_s":
            time.monotonic() - t0}


# ------------------------------------- the CLI's twins of other files

def flight_train_status_cli_and_dashboard_route():
    """tests/test_observability.py test_train_status_cli_and_dashboard_
    route: `train-status` renders the gang view with the straggler
    marked; `--json` and /api/train carry the same runs (int rank keys
    as strings)."""
    c = _conductor()
    for rank in range(2):
        ms = 300.0 if rank == 1 else 100.0
        c.call("report_train_steps", "cli-run", rank,
               [{"step": s, "rank": rank, "total_ms": ms,
                 "device_step_ms": ms, "tokens_per_sec": 1000.0 / ms,
                 "t_start": time.time(), "t_end": time.time()}
                for s in range(5)], timeout=10.0)
    text = cli_text("train-status", "--run", "cli-run")
    assert "cli-run" in text and "STRAGGLER" in text, text
    parsed = cli_json("train-status")
    assert "cli-run" in parsed
    dash = dashboard_json("/api/train")["cli-run"]
    assert set(dash["per_rank"]) == set(parsed["cli-run"]["per_rank"]) \
        == {"0", "1"}
    assert dash["stragglers"] == parsed["cli-run"]["stragglers"] == [1]
    assert dash["last_step"] == parsed["cli-run"]["last_step"] == 4


def resilience_status_cli_and_dashboard_payload():
    """tests/test_resilience.py test_resilience_status_cli_and_
    dashboard_payload: `resilience-status` renders a quarantined host
    and the counters; `--json` and /api/resilience name it excluded."""
    c = _conductor()
    c.call("quarantine_node", "flaky-host", "operator", timeout=10.0)
    c.call("report_preemption", None, None, 5.0, "test", timeout=10.0)
    try:
        text = cli_text("resilience-status")
        assert "flaky-host" in text and "QUARANTINED" in text, text
        assert "counters:" in text
        parsed = cli_json("resilience-status")
        assert "flaky-host" in parsed["excluded"]
        dash = dashboard_json("/api/resilience")
        assert "flaky-host" in dash["excluded"]
        assert dash["counters"] == parsed["counters"]
    finally:
        assert c.call("clear_quarantine", "flaky-host", timeout=10.0)


def port_cli_runtime_views_equal_the_state_api():
    """`summary`, `memory`, `list actors`, `metrics`, `timeline` and
    `timeline --merged` against the state API on one workload, and
    `config` naming every flag of the table."""
    import os
    import tempfile

    from ..util import state
    from .config import config

    assert rt.get([_work.remote(i) for i in range(3)],
                  timeout=60.0) == [0, 2, 4]
    a = rt.remote(_A).options(name="cli-actor").remote()
    assert rt.get(a.ping.remote(), timeout=60.0) == "pong"
    _worker()._flush_task_events()

    def summarized():
        return state.summarize_tasks().get("_work", {}).get("count") == 3

    _wait_until(summarized, 15.0, "task events never reached the conductor")
    summary = json.loads(cli_text("summary"))
    assert summary["_work"]["count"] == 3
    assert set(summary) == set(state.summarize_tasks())
    actors = json.loads(cli_text("list", "actors"))
    assert [x["name"] for x in actors if x["state"] == "ALIVE"] \
        == ["cli-actor"]
    objects = json.loads(cli_text("memory"))
    assert {o["worker_id"] for o in objects} \
        == {o["worker_id"] for o in state.list_objects()}
    from ..util import metrics

    metrics.Counter("cli_checks_total", "a counter of the CLI check").inc()
    metrics.flush()

    def family(text):
        return {ln.split("{", 1)[0].split(" ", 1)[0]
                for ln in text.splitlines() if ln and ln[0] != "#"}

    _wait_until(lambda: "cli_checks_total" in family(
        state.prometheus_metrics()), 15.0, "the counter never landed")
    assert family(cli_text("metrics")) == family(state.prometheus_metrics())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tl.json")
        out = cli_text("timeline", path)
        with open(path) as f:
            trace = json.load(f)
        assert out.startswith(f"wrote {len(trace)} task events to {path}")
        assert any(e["name"] == "_work" for e in trace)
        merged = os.path.join(tmp, "merged.json")
        cli_text("timeline", "--merged", "--output", merged)
        with open(merged) as f:
            cats = {e.get("cat") for e in json.load(f)}
        assert "task" in cats, cats
    from ..scripts import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["config"])  # no address: the flag table of this process
    for row in config.describe():
        assert row["name"] in out.getvalue(), row["name"]
    assert "RTT_ADDRESS" in out.getvalue()
