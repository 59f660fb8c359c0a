"""Serve deployments' checks that need a cluster (serve/), run by
`isolated.run_checks` in a driver process of their own, as
`serve_checks.py`'s are: tests/test_torch_serve.py,
test_torch_serve_streaming.py and test_torch_serve_yaml.py make each one
a test case.

The twins of the JAX package's cluster cases (tests/test_serve.py,
test_serve_streaming.py, test_serve_yaml.py) carry their names and hold
what JAX's hold, over `http.client` where JAX's use `requests`. Each
check starts Serve on its own cluster and shuts it down; `serve.shutdown`
stops the controller, the proxy and every replica. The engine-backed
replicas serve Llama tiny fp32 on weights a test converted from JAX's
`llama_init` (`isolated.inputs()["llama_weights"]`, a `torch.save`
file) and return their streams for the test to hold against JAX's.

This module is also the application the YAML cases' ``import_path``
names (``ray_tpu_torch._private.deploy_checks:app`` / ``:build``): it
lives in the package, so replica processes import it, and it imports no
torch at the top.
"""
from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch as rt
from ray_tpu_torch import serve

# ------------------------------------------------------------- helpers


def _http(method: str, path: str, body: Optional[bytes] = None,
          headers: Optional[Dict[str, str]] = None,
          timeout: float = 60.0) -> Tuple[int, List[Tuple[str, str]], bytes]:
    """One request to the proxy: (status, header pairs, body)."""
    host, port = serve.proxy_address()
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheaders(), r.read()
    finally:
        conn.close()


def _post_json(path: str, obj: Any) -> Tuple[int, Any]:
    status, _, body = _http("POST", path, json.dumps(obj).encode(),
                            {"Content-Type": "application/json"})
    return status, json.loads(body)


def _header(pairs: List[Tuple[str, str]], name: str) -> Optional[str]:
    return next((v for k, v in pairs if k.lower() == name.lower()), None)


def _routed(prefix: str, bound_s: float = 30.0) -> None:
    """Wait until the proxy's route table (its long poll of the
    controller, which serve.run does not wait for) holds `prefix`."""
    deadline = time.monotonic() + bound_s
    while True:
        status, _, body = _http("GET", "/-/routes")
        if status == 200 and prefix in json.loads(body):
            return
        assert time.monotonic() < deadline, \
            f"the proxy has no route {prefix} after {bound_s} s"
        time.sleep(0.05)


@contextlib.contextmanager
def _serve(**start_kwargs):
    serve.start(**start_kwargs)
    try:
        yield
    finally:
        serve.shutdown()


def _quiet_torch():
    """A CPU replica shares the host with the test run's other
    workers: a few threads each."""
    import torch

    torch.set_num_threads(2)


# ------------------------------------------------ runtime stream endpoints


def stream_endpoint_push_and_close():
    """A producer actor pushes frames into a stream endpoint of the
    driver (`Worker.open_stream`, the worker's `stream_chunk` RPC); after
    `close_stream` its push is answered False, so it stops."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.worker import global_worker

    @rt.remote
    class Producer:
        def push(self, addr, stream_id, items):
            from ray_tpu_torch._private import serialization as ser
            from ray_tpu_torch._private.worker import global_worker as gw

            client = gw.clients.get(tuple(addr))
            return [client.call("stream_chunk", stream_id, seq,
                                ser.dumps(x), timeout=30.0)
                    for seq, x in enumerate(items)]

    p = Producer.remote()
    stream_id, q = global_worker.open_stream()
    acks = rt.get(p.push.remote(tuple(global_worker.address), stream_id,
                                ["a", {"b": 2}, [3]]), timeout=60.0)
    assert acks == [True, True, True], acks
    got = [q.get(timeout=10.0) for _ in range(3)]
    assert [s for s, _ in got] == [0, 1, 2], got
    assert [serialization.loads(b) for _, b in got] == ["a", {"b": 2}, [3]]
    global_worker.close_stream(stream_id)
    acks = rt.get(p.push.remote(tuple(global_worker.address), stream_id,
                                ["late"]), timeout=60.0)
    assert acks == [False], acks
    assert q.empty()
    rt.kill(p)


# ------------------------------------------------- twins of test_serve.py


def serve_function_deployment():
    with _serve():
        @serve.deployment
        def echo(request):
            return {"echo": request.json()}

        serve.run(echo.bind(), name="fn_app", route_prefix="/fn")
        _routed("/fn")
        status, body = _post_json("/fn", [1, 2, 3])
        assert status == 200 and body == {"echo": [1, 2, 3]}, (status, body)
        serve.delete("fn_app")


def serve_class_deployment_and_handle():
    with _serve():
        @serve.deployment(num_replicas=2)
        class Adder:
            def __init__(self, offset):
                self.offset = offset

            def add(self, x):
                return x + self.offset

            def __call__(self, request):
                return self.add(request.json()["x"])

        serve.run(Adder.bind(10), name="adder", route_prefix="/adder")
        _routed("/adder")
        h = serve.get_app_handle("adder")
        assert h.add.remote(5).result() == 15
        assert _post_json("/adder", {"x": 1}) == (200, 11)
        st = serve.status()["applications"]["adder"]
        assert st["status"] == "RUNNING"
        assert len(st["deployments"]["Adder"]["replicas"]) == 2
        serve.delete("adder")


def serve_composition():
    with _serve():
        @serve.deployment
        class Preprocess:
            def run(self, x):
                return x * 2

        @serve.deployment
        class Model:
            def __init__(self, pre):
                self.pre = pre

            def __call__(self, x):
                return self.pre.run.remote(x).result() + 1

        h = serve.run(Model.bind(Preprocess.bind()), name="comp",
                      route_prefix="/comp")
        assert h.remote(4).result() == 9
        serve.delete("comp")


def serve_response_passing():
    """A DeploymentResponse passed to another handle call resolves
    without a driver round trip."""
    with _serve():
        @serve.deployment
        class Stage:
            def __call__(self, x):
                return x + 1

        serve.run(Stage.bind(), name="stage", route_prefix="/stage")
        h = serve.get_app_handle("stage")
        resp = h.remote(h.remote(0))
        assert resp.result() == 2
        serve.delete("stage")


def serve_batching():
    with _serve():
        @serve.deployment(max_ongoing_requests=16)
        class Batched:
            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
            def __call__(self, xs):
                assert isinstance(xs, list)
                self.last_batch = len(xs)
                return [x * 10 for x in xs]

            def probe(self):
                return getattr(self, "last_batch", 0)

        serve.run(Batched.bind(), name="batched", route_prefix="/batched")
        h = serve.get_app_handle("batched")
        resps = [h.remote(i) for i in range(8)]
        assert [r.result() for r in resps] == [i * 10 for i in range(8)]
        assert h.probe.remote().result() >= 2  # a real batch formed
        serve.delete("batched")


def serve_multiplex():
    with _serve():
        @serve.deployment
        class Multi:
            def __init__(self):
                self.loads = 0

            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                self.loads += 1
                return {"id": model_id}

            def __call__(self, _x):
                mid = serve.get_multiplexed_model_id()
                return (self.get_model(mid)["id"], self.loads)

        serve.run(Multi.bind(), name="mx", route_prefix="/mx")
        _routed("/mx")
        h = serve.get_app_handle("mx")
        assert h.options(multiplexed_model_id="a").remote(0).result() \
            == ("a", 1)
        assert h.options(multiplexed_model_id="a").remote(0).result() \
            == ("a", 1)
        assert h.options(multiplexed_model_id="b").remote(0).result() \
            == ("b", 2)
        status, _, body = _http("GET", "/mx",
                                headers={"serve_multiplexed_model_id": "c"})
        assert status == 200 and json.loads(body)[0] == "c", (status, body)
        serve.delete("mx")


def serve_user_config_reconfigure():
    with _serve():
        @serve.deployment(user_config={"threshold": 5})
        class Configured:
            def reconfigure(self, config):
                self.threshold = config["threshold"]

            def __call__(self, _x):
                return self.threshold

        serve.run(Configured.bind(), name="cfg", route_prefix="/cfg")
        h = serve.get_app_handle("cfg")
        assert h.remote(0).result() == 5
        serve.delete("cfg")


def serve_replica_recovery():
    """The controller's health checks replace a killed replica."""
    with _serve():
        @serve.deployment(health_check_period_s=0.3)
        class Fragile:
            def pid(self):
                return os.getpid()

        serve.run(Fragile.bind(), name="fragile", route_prefix="/fragile")
        h = serve.get_app_handle("fragile")
        pid1 = h.pid.remote().result()
        ctrl = rt.get_actor("SERVE_CONTROLLER")
        _, replicas = rt.get(ctrl.get_replicas.remote("fragile", "Fragile"))
        rt.kill(replicas[0][1])
        deadline = time.monotonic() + 30.0
        pid2 = None
        while time.monotonic() < deadline:
            try:
                pid2 = h.pid.remote().result(timeout_s=5.0)
                if pid2 != pid1:
                    break
            except Exception:  # noqa: BLE001 — the replica is being replaced
                time.sleep(0.2)
        assert pid2 is not None and pid2 != pid1, (pid1, pid2)
        serve.delete("fragile")


def serve_autoscaling_scale_up():
    with _serve():
        @serve.deployment(
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=1, max_replicas=3, target_ongoing_requests=1,
                upscale_delay_s=0.3, downscale_delay_s=60.0),
            max_ongoing_requests=4)
        class Slow:
            def __call__(self, _x):
                time.sleep(1.0)
                return "done"

        serve.run(Slow.bind(), name="auto", route_prefix="/auto")
        h = serve.get_app_handle("auto")
        resps = [h.remote(i) for i in range(12)]
        deadline = time.monotonic() + 30.0
        scaled = False
        while time.monotonic() < deadline and not scaled:
            st = serve.status()["applications"]["auto"]
            scaled = st["deployments"]["Slow"]["target_num_replicas"] > 1
            time.sleep(0.2)
        for r in resps:
            r.result(timeout_s=60.0)
        assert scaled, "autoscaler never scaled up under sustained load"
        serve.delete("auto")


def serve_404_and_healthz():
    with _serve():
        assert _http("GET", "/-/healthz")[2] == b"success"
        assert _http("GET", "/definitely-not-a-route-xyz")[0] == 404


def serve_asgi_ingress():
    """@serve.ingress(asgi_app): HTTP requests route through any ASGI-3
    callable, with status, headers, query strings and bodies intact."""
    with _serve():
        async def asgi_app(scope, receive, send):
            assert scope["type"] == "http"
            assert scope["root_path"] == "/api", scope["root_path"]
            msg = await receive()
            body = msg.get("body", b"")
            path = scope["path"]
            if path.endswith("/hello"):
                status, payload = 200, b'{"hello": "world"}'
            elif path.endswith("/echo"):
                status, payload = 201, body
            else:
                status, payload = 404, b"nope"
            await send({"type": "http.response.start", "status": status,
                        "headers": [(b"content-type", b"application/json"),
                                    (b"x-served-by", b"asgi")]})
            await send({"type": "http.response.body", "body": payload})

        @serve.deployment
        @serve.ingress(asgi_app)
        class Api:
            pass

        serve.run(Api.bind(), name="asgi_app", route_prefix="/api")
        _routed("/api")
        status, hdrs, body = _http("GET", "/api/hello")
        assert status == 200 and json.loads(body) == {"hello": "world"}
        assert _header(hdrs, "x-served-by") == "asgi"
        status, _, body = _http("POST", "/api/echo", b'{"x": 5}')
        assert status == 201 and json.loads(body) == {"x": 5}
        assert _http("GET", "/api/missing")[0] == 404
        serve.delete("asgi_app")


def serve_response_duplicate_headers():
    """serve.Response with list-of-pairs headers keeps duplicates
    (several Set-Cookie) through the proxy."""
    with _serve():
        @serve.deployment
        def cookies(request):
            return serve.Response(
                "ok", headers=[("Set-Cookie", "a=1"), ("Set-Cookie", "b=2"),
                               ("X-One", "yes")])

        serve.run(cookies.bind(), name="cookie_app", route_prefix="/ck")
        _routed("/ck")
        status, hdrs, body = _http("GET", "/ck")
        assert status == 200 and body == b"ok"
        got = [v for k, v in hdrs if k == "Set-Cookie"]
        assert got == ["a=1", "b=2"], got
        assert _header(hdrs, "X-One") == "yes"
        serve.delete("cookie_app")


def serve_async_function_deployment():
    """An async def deployment resolves its coroutine and sees the
    request context."""
    with _serve():
        @serve.deployment
        async def afn(request):
            from ray_tpu_torch.serve import get_request_context

            return {"route": get_request_context().route,
                    "v": request.json()}

        serve.run(afn.bind(), name="afn_app", route_prefix="/afn")
        _routed("/afn")
        assert _post_json("/afn", 7) == (200, {"route": "/afn", "v": 7})
        serve.delete("afn_app")


def serve_shed_503_and_error_500():
    """The proxy's two error statuses: a request past the admission
    bound (one in flight, none queued) is shed with 503 and Retry-After,
    a replica's exception is 500 with its text. The replica runs its
    metrics call beside the slow request (max_concurrency 4), so the
    shed is sent once the slow one is in flight."""
    import threading

    with _serve():
        @serve.deployment(max_ongoing_requests=1, max_queued_requests=0,
                          ray_actor_options={"max_concurrency": 4})
        class Busy:
            def __call__(self, request):
                if request.path.endswith("/boom"):
                    raise ValueError("no such thing")
                time.sleep(float(request.query_params.get("s", "0")))
                return "ok"

        serve.run(Busy.bind(), name="busy", route_prefix="/busy")
        _routed("/busy")
        status, _, body = _http("GET", "/busy/boom")
        assert status == 500 and b"no such thing" in body, (status, body)
        _, reps = rt.get(rt.get_actor("SERVE_CONTROLLER")
                         .get_replicas.remote("busy", "Busy"), timeout=60.0)
        slow_status = []
        slow = threading.Thread(target=lambda: slow_status.append(
            _http("GET", "/busy?s=5")[0]))
        slow.start()
        deadline = time.monotonic() + 30.0
        while rt.get(reps[0][1].get_metrics.remote(),
                     timeout=30.0)["inflight"] < 1:
            assert time.monotonic() < deadline, \
                "the slow request never reached the replica"
            time.sleep(0.02)
        status, hdrs, _ = _http("GET", "/busy")
        slow.join()
        assert status == 503 and _header(hdrs, "Retry-After") == "1", status
        assert slow_status == [200], slow_status
        serve.delete("busy")


# ------------------------------------------ twins of test_serve_streaming.py

N_TOKENS = 100
TOKEN_DELAY_S = 0.02  # 100 tokens -> ~2 s of generation


@serve.deployment
class TokenStreamer:
    def __call__(self, request):
        def gen():
            for i in range(N_TOKENS):
                time.sleep(TOKEN_DELAY_S)
                yield f"tok{i} "
        return gen()

    def count_up(self, n):
        for i in range(n):
            yield i

    def not_a_stream(self, x):
        return {"plain": x}

    async def agen(self, n):
        for i in range(n):
            yield i * 2

    def boom_mid_stream(self):
        def gen():
            yield "first"
            raise RuntimeError("stream blew up")
        return gen()


@contextlib.contextmanager
def _token_app():
    with _serve():
        serve.run(TokenStreamer.bind(), name="stream_app",
                  route_prefix="/stream")
        _routed("/stream")
        yield serve.get_app_handle("stream_app")
        serve.delete("stream_app")


def stream_handle_first_token_latency():
    with _token_app() as app:
        h = app.options(stream=True)
        t0 = time.monotonic()
        gen = h.remote(None)
        tokens, t_first = [], None
        for tok in gen:
            if t_first is None:
                t_first = time.monotonic() - t0
            tokens.append(tok)
        total = time.monotonic() - t0
        assert len(tokens) == N_TOKENS
        assert tokens[0] == "tok0 " and tokens[-1] == f"tok{N_TOKENS - 1} "
        # streaming: the first token arrives long before the end
        assert t_first < total / 4, (t_first, total)
        assert gen.kind == "gen"


def stream_handle_method_and_asyncgen():
    with _token_app() as app:
        got = list(app.options(stream=True,
                               method_name="count_up").remote(10))
        assert got == list(range(10)), got
        got = list(app.options(stream=True, method_name="agen").remote(5))
        assert got == [0, 2, 4, 6, 8], got


def stream_handle_of_plain_value():
    """stream=True on a plain method: no chunks, `.value` holds it."""
    with _token_app() as app:
        gen = app.options(stream=True,
                          method_name="not_a_stream").remote(42)
        assert list(gen) == []
        assert gen.kind == "value" and gen.value == {"plain": 42}


def stream_handle_error_propagates():
    with _token_app() as app:
        gen = app.options(stream=True,
                          method_name="boom_mid_stream").remote()
        it = iter(gen)
        assert next(it) == "first"
        try:
            while True:
                next(it)
        except StopIteration:
            raise AssertionError("the stream's error was lost") from None
        except Exception as e:  # noqa: BLE001 — the replica's error
            assert "stream blew up" in str(e), e


def _read_stream(path: str, headers: Optional[Dict[str, str]] = None):
    """GET `path` and read its body as it arrives: (status, header pairs,
    chunks as read, seconds to the first chunk, seconds in all)."""
    host, port = serve.proxy_address()
    conn = http.client.HTTPConnection(host, port, timeout=60.0)
    try:
        t0 = time.monotonic()
        conn.request("GET", path, headers=headers or {})
        r = conn.getresponse()
        chunks, t_first = [], None
        while True:
            data = r.read1(65536)
            if not data:
                break
            if t_first is None:
                t_first = time.monotonic() - t0
            chunks.append(data)
        return r.status, r.getheaders(), chunks, t_first, \
            time.monotonic() - t0
    finally:
        conn.close()


def stream_http_chunked():
    with _token_app():
        status, hdrs, chunks, t_first, total = _read_stream("/stream")
        assert status == 200
        assert _header(hdrs, "Transfer-Encoding") == "chunked"
        body = b"".join(chunks).decode()
        assert body.split() == [f"tok{i}" for i in range(N_TOKENS)]
        assert t_first < total / 4, (t_first, total)
        assert len(chunks) > 1, "response was not actually chunked"


def stream_http_sse():
    with _token_app():
        status, hdrs, chunks, _, _ = _read_stream(
            "/stream", {"Accept": "text/event-stream"})
        assert status == 200
        assert _header(hdrs, "Content-Type").startswith("text/event-stream")
        text = b"".join(chunks).decode()
        events = [ln for ln in text.splitlines() if ln.startswith("data: ")]
        assert len(events) == N_TOKENS
        assert events[0] == "data: tok0 "


def _llama_weights():
    """(config, params) on the CPU: the file a test wrote from JAX's
    `llama_init` through `from_jax_params`."""
    import dataclasses

    import torch

    from ray_tpu_torch._private import isolated
    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    return cfg, torch.load(isolated.inputs()["llama_weights"],
                           weights_only=True)


@serve.deployment
class LLM:
    """A replica decoding with `stream_generate` (batch 1)."""

    def __init__(self, cfg, params):
        _quiet_torch()
        self.cfg, self.params = cfg, params

    def __call__(self, prompt_tokens, n=8):
        import torch

        from ray_tpu_torch.models.generate import stream_generate

        prompt = torch.tensor([prompt_tokens], dtype=torch.long)
        for tok in stream_generate(self.params, self.cfg, prompt,
                                   max_new_tokens=n):
            yield int(tok[0])


@serve.deployment(max_ongoing_requests=8)
class EngineLLM:
    """A replica whose concurrent streams share one continuous-batching
    engine."""

    def __init__(self, cfg, params):
        from ray_tpu_torch.models.engine import ContinuousBatchingEngine

        _quiet_torch()
        self.engine = ContinuousBatchingEngine(params, cfg, max_batch=4)

    def __call__(self, prompt_tokens, n=6):
        yield from self.engine.stream(prompt_tokens, n)

    def shutdown(self):
        self.engine.stop()


def stream_llm_replica_streams_tokens():
    """A Llama replica streams through a handle; returns the streams
    for the test to hold against JAX's `stream_generate`."""
    cfg, params = _llama_weights()
    with _serve():
        serve.run(LLM.bind(cfg, params), name="llm_app",
                  route_prefix="/llm")
        h = serve.get_app_handle("llm_app").options(stream=True)
        toks = list(h.remote([1, 2, 3, 4], n=6))
        assert len(toks) == 6 and all(isinstance(t, int) for t in toks)
        again = list(h.remote([1, 2, 3, 4], n=6))
        assert again == toks, (toks, again)
        serve.delete("llm_app")
    return {"tokens": toks}


def stream_llm_continuous_batching_replica():
    """Concurrent streams share one engine in one replica; returns them
    (and a resubmission) for the test to hold against JAX's engine."""
    import concurrent.futures as cf

    cfg, params = _llama_weights()
    with _serve():
        serve.run(EngineLLM.bind(cfg, params), name="engine_app",
                  route_prefix="/eng")
        h = serve.get_app_handle("engine_app").options(stream=True)

        def run(prompt):
            return list(h.remote(prompt, n=6))

        with cf.ThreadPoolExecutor(3) as pool:
            outs = [f.result(timeout=120) for f in
                    [pool.submit(run, [i + 1, i + 2]) for i in range(3)]]
        for out in outs:
            assert len(out) == 6, outs
        again = run([1, 2])
        assert again == outs[0], (outs[0], again)
        serve.delete("engine_app")
    return {"streams": outs}


# -------------------------------------------- twins of test_serve_yaml.py


@serve.deployment
class Doubler:
    def __init__(self, bias: int = 0):
        self.bias = bias

    def __call__(self, request):
        return {"value": 2 * request.json()["x"] + self.bias}


app = Doubler.bind()


def build(args):
    """Builder-function import path: a bound app from the config's
    args."""
    return Doubler.bind(int(args.get("bias", 0)))


_IMPORT = "ray_tpu_torch._private.deploy_checks"


def _yaml_config(num_replicas: int) -> dict:
    return {"applications": [{
        "name": "yamlapp",
        "route_prefix": "/yaml",
        "import_path": f"{_IMPORT}:app",
        "deployments": [{"name": "Doubler", "num_replicas": num_replicas}],
    }]}


def yaml_deploy_and_hot_update():
    import yaml

    from ray_tpu_torch.serve.schema import (ServeDeploySchema,
                                            deploy_config,
                                            get_deployed_config)

    with _serve(), tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.yaml")
        with open(path, "w") as f:
            f.write(yaml.safe_dump(_yaml_config(1)))
        names = deploy_config(ServeDeploySchema.from_yaml_file(path))
        assert names == ["yamlapp"], names
        _routed("/yaml")
        assert _post_json("/yaml", {"x": 21}) == (200, {"value": 42})
        st = serve.status()["applications"]["yamlapp"]
        assert st["deployments"]["Doubler"]["target_num_replicas"] == 1
        # declarative hot update: 1 -> 3 replicas by re-deploying
        deploy_config(ServeDeploySchema.from_dict(_yaml_config(3)))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = serve.status()["applications"].get("yamlapp", {})
            if st.get("deployments", {}).get("Doubler", {}).get(
                    "target_num_replicas") == 3:
                break
            time.sleep(0.5)
        assert st["deployments"]["Doubler"]["target_num_replicas"] == 3
        assert _post_json("/yaml", {"x": 5}) == (200, {"value": 10})
        # the deployed schema comes back from the cluster KV
        cfg = get_deployed_config()
        assert cfg["applications"][0]["name"] == "yamlapp"
        assert cfg["applications"][0]["deployments"][0]["num_replicas"] \
            == 3
        serve.delete("yamlapp")


def yaml_builder_function_with_args():
    from ray_tpu_torch.serve.schema import ServeDeploySchema, deploy_config

    with _serve():
        deploy_config(ServeDeploySchema.from_dict({"applications": [{
            "name": "biased", "route_prefix": "/biased",
            "import_path": f"{_IMPORT}:build", "args": {"bias": 7}}]}))
        _routed("/biased")
        assert _post_json("/biased", {"x": 1}) == (200, {"value": 9})
        serve.delete("biased")


def yaml_override_unknown_deployment_fails():
    from ray_tpu_torch.serve.schema import ServeDeploySchema, deploy_config

    with _serve():
        schema = ServeDeploySchema.from_dict({"applications": [{
            "name": "bad", "import_path": f"{_IMPORT}:app",
            "deployments": [{"name": "NoSuch", "num_replicas": 2}]}]})
        try:
            deploy_config(schema)
        except ValueError as e:
            assert "NoSuch" in str(e), e
        else:
            raise AssertionError("an override of no deployment deployed")


def yaml_cli_serve_deploy_and_status():
    """`serve deploy config.yaml`, `serve status`, `serve config` and
    `serve delete` against the live cluster."""
    import yaml

    from ray_tpu_torch._private import worker as wmod
    from ray_tpu_torch.scripts import cli

    host, port = wmod.global_worker.conductor_address

    def run(*argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["serve", "--address", f"{host}:{port}", *argv])
        return out.getvalue()

    with _serve(), tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cli_serve.yaml")
        with open(path, "w") as f:
            f.write(yaml.safe_dump({"applications": [{
                "name": "cliapp", "route_prefix": "/cli",
                "import_path": f"{_IMPORT}:app"}]}))
        assert "cliapp" in run("deploy", path)
        _routed("/cli")
        assert _post_json("/cli", {"x": 2}) == (200, {"value": 4})
        assert "cliapp" in run("status")
        # the address from RTT_ADDRESS, as the JAX twin's from its
        # variable; `serve status` and the dashboard's /api/serve agree
        from ray_tpu_torch._private.conductor import ENV_ADDRESS

        from .cluster_checks import _wait_until
        from .dashboard_checks import dashboard_json

        prior = os.environ.get(ENV_ADDRESS)
        os.environ[ENV_ADDRESS] = f"{host}:{port}"
        try:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["serve", "status"])
        finally:
            if prior is None:
                os.environ.pop(ENV_ADDRESS)
            else:
                os.environ[ENV_ADDRESS] = prior
        apps = json.loads(out.getvalue())["applications"]
        assert apps["cliapp"]["status"] == "RUNNING", apps

        def mirrored():
            dash = dashboard_json("/api/serve")["applications"]
            return dash.get("cliapp", {}).get("status") == "RUNNING"

        _wait_until(mirrored, 15.0, "/api/serve never showed cliapp")
        assert f"{_IMPORT}:app" in run("config")
        run("delete", "cliapp")
        assert "cliapp" not in serve.status()["applications"]
