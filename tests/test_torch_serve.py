"""Serve deployments of the port (ray_tpu_torch/serve/: the controller,
replicas, handles and their router, the HTTP proxy, batching,
multiplexing, ASGI) against the JAX package's, on the CPU.

Twins of the 15 cases of tests/test_serve.py: the 13 that need a cluster
are functions of `_private/deploy_checks.py`, each run with a cluster of
its own in one driver process (`isolated.run_checks`), HTTP over
`http.client`; the two per-instance cases run here on both packages.
Beside them: the runtime's stream endpoints (a producer actor's push
after `close_stream` is answered False) and the proxy's 503 / 500.

Parity on seeded inputs, each against the named JAX function:
`Router._try_pick` (bound, shed, choice and increments over random
in-flight states, one seeded draw for both), `coerce_response`, the ASGI
scope, `DeploymentConfig.validate` / `AutoscalingConfig.validate` errors,
`@serve.batch` grouping of one arrival sequence, the multiplex LRU over
one random id sequence, and `_build_app_config`'s deployment graph of a
composed application.

The HTTP/1.1 layer the proxy and the gateway share (serve/_http.py): a
server whose start fails after the bind refuses connections, the
gateway's first telemetry push (run on the server's thread at the bind)
finds the server on the gateway, and a response keeps duplicate
headers.
"""
from __future__ import annotations

import random
import time

import pytest

from ray_tpu import serve as jserve
from ray_tpu.serve import asgi as jasgi
from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import handle as jhandle
from ray_tpu.serve import http_util as jhttp
from ray_tpu.serve import multiplex as jmultiplex
from ray_tpu_torch import serve as tserve
from ray_tpu_torch._private import isolated
from ray_tpu_torch.serve import asgi as tasgi
from ray_tpu_torch.serve import batching as tbatching
from ray_tpu_torch.serve import handle as thandle
from ray_tpu_torch.serve import http_util as thttp
from ray_tpu_torch.serve import multiplex as tmultiplex

CLUSTER = {"num_cpus": 8}
CHECKS = {name: CLUSTER for name in (
    "stream_endpoint_push_and_close",
    "serve_function_deployment",
    "serve_class_deployment_and_handle",
    "serve_composition",
    "serve_response_passing",
    "serve_batching",
    "serve_multiplex",
    "serve_user_config_reconfigure",
    "serve_replica_recovery",
    "serve_autoscaling_scale_up",
    "serve_404_and_healthz",
    "serve_asgi_ingress",
    "serve_response_duplicate_headers",
    "serve_async_function_deployment",
    "serve_shed_503_and_error_500")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=420.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_serve_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------ twins without a cluster

@pytest.mark.parametrize("serve", [tserve, jserve], ids=["port", "jax"])
def test_batch_state_is_per_instance(serve):
    """Two instances of a @serve.batch class do not share one queue."""
    class M:
        def __init__(self, scale):
            self.scale = scale

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
        def __call__(self, xs):
            return [x * self.scale for x in xs]

    a, b = M(10), M(100)
    assert a(1) == 10 and b(1) == 100


@pytest.mark.parametrize("serve", [tserve, jserve], ids=["port", "jax"])
def test_multiplex_cache_is_per_instance(serve):
    class M:
        def __init__(self, tag):
            self.tag = tag

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return (self.tag, model_id)

    a, b = M("a"), M("b")
    assert a.get_model("m") == ("a", "m")
    assert b.get_model("m") == ("b", "m")


# ------------------------------------------------------------- the API

def test_api_names_match_jax_but_grpc():
    """The port exports JAX's serve API, apart from the gRPC helpers;
    a gRPC port is refused, naming the roadmap."""
    jax_names = {n for n in dir(jserve) if not n.startswith("_")
                 and (getattr(getattr(jserve, n), "__module__", "")
                      or "").startswith("ray_tpu.serve")}
    assert len(jax_names) > 40
    for const in ("CONTROLLER_NAME", "BATCH", "INTERACTIVE"):
        assert getattr(tserve, const) == getattr(jserve, const)
    grpc = {"grpc_address", "grpc_call"}
    missing = sorted(n for n in jax_names - grpc
                     if not hasattr(tserve, n))
    assert not missing, missing
    assert not any(hasattr(tserve, n) for n in grpc)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tserve.HTTPOptions(grpc_port=0)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tserve.start(grpc_port=9000)


def test_serve_package_imports_no_torch():
    """A replica, the controller and the proxy import `serve`; torch
    comes in only with the disaggregated servers."""
    import subprocess
    import sys

    code = ("import sys\nimport ray_tpu_torch.serve as s\n"
            "from ray_tpu_torch.serve import controller, proxy, replica\n"
            "assert 'torch' not in sys.modules\n"
            "s.DisaggRouter\nassert 'torch' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_request_tenant_is_the_multiplexed_model_id():
    for mod in (tmultiplex, jmultiplex):
        assert mod.request_tenant() is None
    for mod, ctx in ((tmultiplex, "ray_tpu_torch.serve.context"),
                     (jmultiplex, "ray_tpu.serve.context")):
        import importlib

        c = importlib.import_module(ctx)
        tok = c.set_request_context(c.RequestContext(
            multiplexed_model_id="tenant-7"))
        try:
            assert mod.request_tenant() == "tenant-7"
            assert mod.get_multiplexed_model_id() == "tenant-7"
        finally:
            c._request_context.reset(tok)


# ---------------------------------------------------------------- parity

class _StubReplica:
    def __init__(self, tag):
        self.tag = tag

    def __repr__(self):
        return self.tag


@pytest.mark.parametrize("seed", range(4))
def test_router_try_pick_matches_jax(seed):
    """Admission bound, shed, choice and increments of `_try_pick`
    over random replica sets and in-flight states: both routers hold the
    same state and draw from one seeded stream."""
    rng = random.Random(seed)
    for trial in range(300):
        n = rng.randint(0, 5)
        reps = [(f"r{i}", _StubReplica(f"r{i}")) for i in range(n)]
        inflight = {tag: rng.randint(0, 6) for tag, _ in reps}
        bound = rng.choice([None, 1, 2, 3, 5])
        routers = [thandle.Router("d", "a"), jhandle.Router("d", "a")]
        for r in routers:
            r._replicas = list(reps)
            r._inflight = dict(inflight)
        draw = rng.random()
        got = []
        for mod, r in zip((thandle, jhandle), routers):
            random.seed(draw)
            out = r._try_pick(bound)
            shed = out is r._SHED
            got.append((None if out is None else
                        "SHED" if shed else out[0], dict(r._inflight)))
        assert got[0] == got[1], (seed, trial, bound, inflight, got)
        if got[0][0] not in (None, "SHED"):
            assert inflight[got[0][0]] < (bound or 10 ** 9)


@pytest.mark.parametrize("ongoing, queued", [
    (None, None), (4, -1), (4, 2), (4, 0), (16, 5)])
def test_router_shed_bound_matches_jax(monkeypatch, ongoing, queued):
    """The shed bound comes from the deployment config's
    `max_ongoing_requests + max_queued_requests` as in JAX with its
    RAY_TPU_SERVE_MAX_QUEUE_DEPTH unset (the port has no such override);
    the shed carries JAX's retry hint and counts."""
    monkeypatch.delenv("RAY_TPU_SERVE_MAX_QUEUE_DEPTH", raising=False)
    monkeypatch.delenv("RAY_TPU_SERVE_RETRY_AFTER_S", raising=False)
    limits = {}
    if ongoing is not None:  # as ServeController.get_deployment_limits
        cfg = tserve.DeploymentConfig(max_ongoing_requests=ongoing,
                                      max_queued_requests=queued)
        limits = {"max_ongoing_requests": cfg.max_ongoing_requests,
                  "max_queued_requests": cfg.max_queued_requests}
    t = thandle.Router("d", "a")
    j = jhandle.Router("d", "a")
    t._limits, j._limits = dict(limits), dict(limits)
    assert t._shed_bound() == j._shed_bound()
    if queued is not None and queued >= 0:
        assert t._shed_bound() == ongoing + queued
    before = thandle.shed_counter().series()
    with pytest.raises(thandle.RequestShedError) as e:
        t._raise_shed(3)
    with pytest.raises(jhandle.RequestShedError) as je:
        j._raise_shed(3)
    assert str(e.value) == str(je.value)
    assert e.value.retry_after_s == je.value.retry_after_s == 1.0
    assert thandle.shed_counter().series() != before


@pytest.mark.parametrize("value", [
    "text", b"\x00bytes", {"k": [1, 2]}, [1, "x"], 42, None, (201, "made"),
    (404, {"e": 1}), (500, b"raw"), ("not", "status"), 1.5])
def test_coerce_response_matches_jax(value):
    assert thttp.coerce_response(value) == jhttp.coerce_response(value)


def test_coerce_response_of_response_objects_matches_jax():
    for hdrs in (None, {"X-A": "1"}, [("Set-Cookie", "a=1"),
                                      ("Set-Cookie", "b=2")]):
        for body in ("ok", b"raw", {"j": 1}):
            t = thttp.coerce_response(thttp.Response(body, 202, hdrs))
            j = jhttp.coerce_response(jhttp.Response(body, 202, hdrs))
            assert t == j


@pytest.mark.parametrize("root", ["", "/api"])
def test_asgi_scope_matches_jax(root):
    for method, path, qs, headers, body in [
            ("GET", "/api/hello", "", {}, b""),
            ("POST", "/api/echo", "a=1&b=two",
             {"Content-Type": "application/json", "X-Y": "z"}, b'{"x": 5}')]:
        t = tasgi._build_scope(thttp.Request(method, path, qs, headers,
                                             body), root)
        j = jasgi._build_scope(jhttp.Request(method, path, qs, headers,
                                             body), root)
        assert t == j


def _error_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error is the result
        return type(e).__name__, str(e)
    return None


def test_config_validate_errors_match_jax():
    from ray_tpu.serve import config as jc
    from ray_tpu_torch.serve import config as tc

    rng = random.Random(0)
    for _ in range(400):
        a = dict(min_replicas=rng.randint(-2, 4),
                 max_replicas=rng.randint(-1, 5),
                 target_ongoing_requests=rng.choice([-1.0, 0.0, 0.5, 2.0]))
        d = dict(num_replicas=rng.randint(-2, 3),
                 max_ongoing_requests=rng.randint(-1, 3),
                 max_queued_requests=rng.randint(-3, 2))
        use_auto = rng.random() < 0.5
        for kind in ("auto", "deploy"):
            if kind == "auto":
                t = _error_of(tc.AutoscalingConfig(**a).validate)
                j = _error_of(jc.AutoscalingConfig(**a).validate)
            else:
                t = _error_of(tc.DeploymentConfig(
                    **d, autoscaling_config=(tc.AutoscalingConfig(**a)
                                             if use_auto else None)
                ).validate)
                j = _error_of(jc.DeploymentConfig(
                    **d, autoscaling_config=(jc.AutoscalingConfig(**a)
                                             if use_auto else None)
                ).validate)
            assert t == j, (a, d, use_auto, t, j)


def _batches(mod, bursts, max_batch):
    """The batches a `_BatchQueue` forms when the items of each burst
    are all queued before the flusher looks, the burst waited out
    before the next."""
    seen = []

    def fn(xs):
        seen.append(list(xs))
        return [x * 2 for x in xs]

    q = mod._BatchQueue(fn, max_batch, 0.01)
    n = 0
    for size in bursts:
        futs = []
        for _ in range(size):
            from concurrent.futures import Future

            f = Future()
            q._queue.put((None, n, f))
            futs.append((n, f))
            n += 1
        q._ensure_thread()
        for x, f in futs:
            assert f.result(timeout=10) == x * 2
    return seen


@pytest.mark.parametrize("seed", range(3))
def test_batch_grouping_matches_jax(seed):
    rng = random.Random(seed)
    bursts = [rng.randint(1, 13) for _ in range(8)]
    max_batch = rng.choice([2, 3, 4, 8])
    t = _batches(tbatching, bursts, max_batch)
    j = _batches(jbatching, bursts, max_batch)
    assert t == j, (bursts, max_batch)
    assert sum(map(len, t)) == sum(bursts)


@pytest.mark.parametrize("seed", range(3))
def test_multiplex_lru_matches_jax(seed):
    rng = random.Random(seed)
    ids = [f"m{rng.randint(0, 6)}" for _ in range(200)]
    cap = rng.randint(1, 4)
    trace = {}
    for name, mod in (("port", tmultiplex), ("jax", jmultiplex)):
        loads, evicted = [], []

        class Model:
            def __init__(self, mid):
                self.mid = mid

            def shutdown(self):
                evicted.append(self.mid)

        def loader(mid):
            loads.append(mid)
            return Model(mid)

        cache = mod._ModelCache(loader, cap)
        got = [cache.get(None, mid).mid for mid in ids]
        assert got == ids
        trace[name] = (loads, evicted, cache.model_ids())
    assert trace["port"] == trace["jax"]


def _graph(serve_mod, replica_mod):
    """A composed app: Ingress(pre=Pre, models=[A, A], opts={"b": B})
    with per-deployment options."""
    import cloudpickle

    @serve_mod.deployment(num_replicas=2, max_ongoing_requests=3)
    class Pre:
        pass

    @serve_mod.deployment
    class A:
        pass

    @serve_mod.deployment(user_config={"t": 1})
    class B:
        pass

    @serve_mod.deployment(name="Front")
    class Ingress:
        pass

    a = A.bind()
    app = Ingress.bind(Pre.bind(), [a, a], opts={"b": B.bind(), "n": 3})
    cfg = serve_mod._build_app_config(app, "graph", "/g")

    def plain(obj):
        if isinstance(obj, replica_mod.HandleMarker):
            return ("handle", obj.deployment_name)
        if isinstance(obj, (list, tuple)):
            return [plain(x) for x in obj]
        if isinstance(obj, dict):
            return {k: plain(v) for k, v in obj.items()}
        return obj

    out = {k: cfg[k] for k in ("name", "route_prefix", "ingress")}
    out["deployments"] = [
        {"name": d["name"],
         "callable": cloudpickle.loads(d["serialized_callable"]).__name__,
         "init_args": plain(cloudpickle.loads(d["init_args"])),
         "config": {k: getattr(d["config"], k) for k in (
             "num_replicas", "max_ongoing_requests", "max_queued_requests",
             "user_config", "autoscaling_config",
             "health_check_period_s", "ray_actor_options")}}
        for d in cfg["deployments"]]
    return out


def test_build_app_config_graph_matches_jax():
    from ray_tpu.serve import replica as jreplica
    from ray_tpu_torch.serve import replica as treplica

    assert _graph(tserve, treplica) == _graph(jserve, jreplica)


def test_deployment_options_match_jax():
    for serve_mod in (tserve, jserve):
        d = serve_mod.deployment(lambda x: x, name="f")
        o = d.options(num_replicas="auto")
        assert o.config.autoscaling_config.max_replicas == 8
        assert o.options(autoscaling_config={"min_replicas": 2,
                                             "max_replicas": 3}
                         ).config.autoscaling_config.min_replicas == 2
        with pytest.raises(TypeError, match="cannot be called directly"):
            d(1)


def test_streaming_response_iterates_pushed_chunks_in_order():
    """The handle's stream consumer reorders pushed frames by seq and
    ends once the replica's reply counted them all (JAX's and the
    port's, on the same frames; no cluster: a stub reply ref)."""
    import queue

    from ray_tpu._private import serialization as jser
    from ray_tpu_torch._private import serialization as tser

    frames = [3, 0, 2, 1, 4]
    for mod, ser in ((thandle, tser), (jhandle, jser)):
        q = queue.Queue()
        for s in frames:
            q.put((s, ser.dumps(f"c{s}")))

        class Resp(mod.StreamingDeploymentResponse):
            def _check_final(self):
                self.kind, self._total = "gen", len(frames)

            def _finish(self):
                self._finished = True

        r = Resp(None, None, "tag", "sid", q)
        assert list(r) == [f"c{i}" for i in range(len(frames))]


def test_router_assign_async_does_not_block_the_loop():
    """`remote_async` waits for a replica with `await asyncio.sleep`:
    another coroutine on the loop keeps running meanwhile (port only:
    the JAX twin runs under a cluster)."""
    import asyncio

    r = thandle.Router("d", "a")
    r._refresh = lambda force=False: None
    ticks = []

    async def ticker():
        for _ in range(3):
            ticks.append(1)
            await asyncio.sleep(0.02)

    async def main():
        r._PICK_TIMEOUT_S = 0.2
        t = asyncio.ensure_future(ticker())
        with pytest.raises(TimeoutError):
            await r._pick_async(None)
        await t

    asyncio.run(main())
    assert len(ticks) == 3


# -------------------------------------------------- the shared HTTP layer

def test_http_server_that_fails_after_binding_refuses_connections():
    """A server whose startup fails after the bind closes its socket: a
    client is refused at once instead of waiting on a socket no loop
    reads."""
    import socket

    from ray_tpu_torch.serve import _http

    async def dispatch(request):
        return _http._text_response("never")

    def boom():
        raise RuntimeError("on_bound failed")

    srv = _http.HttpServer(dispatch, "127.0.0.1", 0, name="t", server="t",
                           label="t", max_body=lambda: 1024, on_bound=boom)
    srv.start()
    port = srv.wait_ready(30.0, "test server")
    srv._thread.join(timeout=30.0)
    assert not srv._thread.is_alive()
    assert isinstance(srv._start_error, RuntimeError)
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=10.0)


def test_gateway_on_bound_sees_its_server(monkeypatch):
    """The gateway's first telemetry push (run on the server's thread as
    soon as the socket is bound) reads the server's port: the server
    must already be on the gateway. A start that waits for the bind
    before returning makes the old race certain."""
    import http.client

    from ray_tpu_torch.serve import _http, gateway

    real_start = _http.HttpServer.start

    def start_and_wait(self):
        real_start(self)
        self._ready.wait(30.0)
        for _ in range(100):  # let on_bound finish
            if self._thread.is_alive() and self._start_error is None:
                break
            time.sleep(0.01)

    monkeypatch.setattr(_http.HttpServer, "start", start_and_wait)

    class Router:
        def stats(self):
            return {}

    gw = gateway.GatewayServer(Router(), model="m", vocab_size=16)
    try:
        host, port = gw.ready()
        time.sleep(0.3)
        assert gw._http._start_error is None
        conn = http.client.HTTPConnection(host, port, timeout=30.0)
        conn.request("GET", "/-/healthz")
        r = conn.getresponse()
        assert r.status == 200 and r.read() == b"ok"
        conn.close()
    finally:
        gw.stop()


def test_response_encoding_keeps_duplicate_headers():
    from ray_tpu_torch.serve import _http

    r = _http._Response(b"ok", 201, headers=[("Set-Cookie", "a=1"),
                                             ("Set-Cookie", "b=2"),
                                             ("content-type", "text/x")])
    raw = r.encode("HTTP/1.1", server="s").decode("latin-1")
    head, _, body = raw.partition("\r\n\r\n")
    lines = head.split("\r\n")
    assert lines[0] == "HTTP/1.1 201 Created" and body == "ok"
    assert [ln for ln in lines if ln.startswith("Set-Cookie")] == \
        ["Set-Cookie: a=1", "Set-Cookie: b=2"]
    assert [ln.lower() for ln in lines
            if ln.lower().startswith("content-type")] == \
        ["content-type: text/x"]
    assert "Content-Length: 2" in lines and "Server: s" in lines
