"""HTTP proxy actor (the port of ray_tpu/serve/proxy.py) — the
reference's python/ray/serve/_private/proxy.py (ProxyActor :1111,
HTTPProxy.__call__ :836, proxy_request :423) + proxy_router.py
(longest-prefix route matching).

The server is the port's standard-library HTTP/1.1 layer
(serve/_http.py, shared with the gateway), on a thread and event loop of
its own inside the actor. Replica calls are blocking actor calls run on a
thread pool, so the loop stays free. Routes come from the controller by
long poll. ``/-/healthz`` answers ``success`` and ``/-/routes`` the route
table; an unknown path gets 404, a shed 503 with ``Retry-After``, a
failure 500 with its text. Every request rides the replica's streaming
path: a plain result is one response with its status and headers
(duplicates kept), a generator's chunks go out in chunked transfer
encoding, or as SSE frames when ``Accept`` has ``text/event-stream``.

Where the port differs: no gRPC ingress (``grpc_port`` must be None;
``grpc_address()`` returns None, as JAX's does when it is off); a body is
read by ``Content-Length`` only (256 MiB at most, aiohttp's
``client_max_size`` in JAX's proxy), and every whole response carries
``X-Request-Id``.
"""
from __future__ import annotations

import asyncio
import json
import sys
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

from ._http import (_CLIENT_GONE, _CLOSED, HttpServer, _json_response,
                    _Request, _Response, _StreamResponse, _text_response)
from .handle import (CONTROLLER_NAME, DeploymentHandle, RequestMetadata,
                     RequestShedError)
from .http_util import Request, coerce_response

MULTIPLEX_HEADER = "serve_multiplexed_model_id"
# the JAX proxy's aiohttp client_max_size
CLIENT_MAX_SIZE = 256 * 1024 * 1024
_SERVER = (f"Python/{sys.version_info[0]}.{sys.version_info[1]} "
           f"ray_tpu_torch-serve")


def _encode_chunk(item, sse: bool) -> bytes:
    """Wire form of one streamed chunk: SSE data-frames when the client
    asked for an event stream, raw bytes otherwise."""
    if isinstance(item, bytes):
        data = item
    elif isinstance(item, str):
        data = item.encode()
    else:
        data = json.dumps(item, default=str).encode()
    if sse:
        # one 'data:' field line per embedded newline, per the SSE spec —
        # a raw newline inside a data line would be dropped by compliant
        # event-stream parsers
        return b"".join(b"data: " + ln + b"\n"
                        for ln in data.split(b"\n")) + b"\n"
    return data


class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 grpc_port: Optional[int] = None,
                 advertise_host: Optional[str] = None):
        if grpc_port is not None:
            from .config import GRPC_NOT_PORTED

            raise NotImplementedError(GRPC_NOT_PORTED)
        # bind on `host`; report `advertise_host` (a non-head node's
        # reachable IP when binding a wildcard address) to clients
        self._host = host
        self._advertise_host = advertise_host or host
        self._routes: Dict[str, Tuple[str, str]] = {}
        self._handles: Dict[Tuple[str, str], DeploymentHandle] = {}
        self._route_version = -1
        self._shutdown = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=32,
                                        thread_name_prefix="proxy-call")
        self._http = HttpServer(
            self._dispatch, host, port, name="serve-proxy-http",
            server=_SERVER, label="serve proxy",
            max_body=lambda: CLIENT_MAX_SIZE)
        self._http.start()
        threading.Thread(target=self._route_poll_loop, daemon=True,
                         name="serve-proxy-routes").start()

    # -- control ------------------------------------------------------------
    def ready(self) -> Tuple[str, int]:
        return (self._advertise_host,
                self._http.wait_ready(30.0, "proxy HTTP server"))

    def grpc_address(self) -> Optional[Tuple[str, int]]:
        return None

    def graceful_shutdown(self) -> bool:
        self._shutdown.set()
        self._http.stop()
        self._pool.shutdown(wait=False, cancel_futures=True)
        return True

    def _controller(self):
        import ray_tpu_torch as rt
        return rt.get_actor(CONTROLLER_NAME)

    def _route_poll_loop(self):
        import ray_tpu_torch as rt
        while not self._shutdown.is_set():
            try:
                ctrl = self._controller()
                version = rt.get(ctrl.poll_update.remote(
                    self._route_version, 5.0), timeout=15.0)
                if version != self._route_version:
                    self._route_version = version
                    self._routes = rt.get(
                        ctrl.get_route_table.remote(), timeout=10.0)
            except Exception:  # noqa: BLE001 — controller restarting
                self._shutdown.wait(1.0)

    # -- data plane ---------------------------------------------------------
    def _match_route(self, path: str) -> Optional[Tuple[str, str, str]]:
        """Longest-prefix match — reference proxy_router.py."""
        best = None
        for prefix, (app, ingress) in self._routes.items():
            norm = prefix.rstrip("/") or ""
            if path == norm or path.startswith(norm + "/") or prefix == "/":
                if best is None or len(norm) > len(best[0].rstrip("/")):
                    best = (prefix, app, ingress)
        return best

    def _handle_for(self, app: str, deployment: str) -> DeploymentHandle:
        key = (app, deployment)
        if key not in self._handles:
            self._handles[key] = DeploymentHandle(deployment, app)
        return self._handles[key]

    def _call_replica(self, app: str, ingress: str, req: Request,
                      route: str):
        """Every HTTP request rides the streaming path (reference: the
        proxy always calls handle_request_streaming, replica.py:470) —
        plain returns come back in the final reply with zero stream
        traffic, generator returns stream chunk-by-chunk."""
        handle = self._handle_for(app, ingress)
        meta = RequestMetadata(
            call_method="__call__", is_http=True, app_name=app, route=route,
            multiplexed_model_id=req.headers.get(MULTIPLEX_HEADER, ""))
        return handle._router.assign_stream(meta, (req,), {})

    def _call_and_open(self, app: str, ingress: str, req: Request,
                       route: str):
        """assign + first_event with a dead-replica retry: a request
        whose replica died before producing ANY event never executed to
        completion and is safe to re-route — the redeploy/drain window
        (reference proxy retries DeploymentUnavailable/actor-death
        errors against the refreshed replica set)."""
        from ..exceptions import ActorDiedError

        last_err = None
        for attempt in range(3):
            sresp = self._call_replica(app, ingress, req, route)
            try:
                return sresp, sresp.first_event()
            except ActorDiedError as e:
                last_err = e
                handle = self._handle_for(app, ingress)
                handle._router._refresh(force=True)
        raise last_err

    async def _dispatch(self, request: _Request) -> Any:
        path = request.path
        if path == "/-/healthz":
            return _text_response("success")
        if path == "/-/routes":
            return _json_response(
                {p: f"{a}#{d}" for p, (a, d) in self._routes.items()})
        match = self._match_route(path)
        if match is None:
            return _text_response(
                f"no application matches path '{path}'; routes: "
                f"{json.dumps(sorted(self._routes))}", status=404)
        prefix, app, ingress = match
        req = Request(method=request.method, path=path,
                      query_string=request.query_string,
                      headers=dict(request.headers.items()),
                      body=request.body)
        if request.headers.get("x-request-id") is None:
            req.headers["x-request-id"] = uuid.uuid4().hex
        loop = asyncio.get_running_loop()
        try:
            sresp, first = await loop.run_in_executor(
                self._pool, self._call_and_open, app, ingress, req, prefix)
        except RequestShedError as e:
            # admission control shed: 503 + Retry-After, the standard
            # backpressure contract for HTTP clients
            return _text_response(
                str(e), status=503,
                headers={"Retry-After": str(max(1, int(e.retry_after_s)))})
        except Exception as e:  # noqa: BLE001 — surface as 500
            return _text_response(f"{type(e).__name__}: {e}", status=500)
        if first[0] == "value":
            status, headers, payload = coerce_response(first[1])
            # list-of-pairs headers preserve duplicates (Set-Cookie)
            return _Response(payload, status, headers=headers)
        # generator result: chunked transfer; SSE framing when the
        # client asked for text/event-stream
        sse = "text/event-stream" in (request.headers.get("Accept") or "")
        resp = _StreamResponse(request, {
            "Content-Type": ("text/event-stream" if sse
                             else "text/plain; charset=utf-8")})
        _done = object()
        item = first[1] if first[0] == "chunk" else _done
        try:
            while item is not _done:
                await resp.write(_encode_chunk(item, sse))
                item = await loop.run_in_executor(
                    self._pool, lambda: next(sresp, _done))
        except _CLIENT_GONE:
            sresp._finish()  # the consumer is gone: the replica stops
            return _CLOSED
        except Exception:  # noqa: BLE001 — replica died mid-stream:
            pass           # nothing valid left to write; close the wire
        try:
            await resp.write_eof()
        except _CLIENT_GONE:
            return _CLOSED
        return resp
