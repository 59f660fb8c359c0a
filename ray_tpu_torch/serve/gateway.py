"""OpenAI-compatible HTTP front door for the serving plane (the port of
ray_tpu/serve/gateway.py).

An asyncio ingress tier (one event loop on its own thread) that speaks
real sockets, so slow clients, dropped connections and mixed traffic
classes meet real backpressure, and bridges onto the blocking
``DisaggRouter.generate`` through an executor pool plus the router's
``on_tokens`` callback (tokens cross to the loop by
``call_soon_threadsafe``), re-framed as SSE.

Routes::

    POST /v1/completions        OpenAI text completion (+ SSE stream)
    POST /v1/chat/completions   OpenAI chat completion (+ SSE stream)
    GET  /v1/models             the model -> router table
    GET  /-/healthz             liveness
    GET  /-/gateway             this replica's stats snapshot (JSON)

Request contract:

- ``Authorization: Bearer <key>`` resolves the tenant through the QoS
  gate's API-key table (serve/qos.py); ``X-Tenant`` (or OpenAI's
  ``user`` field) is the keyless fallback.
- ``priority`` body field / ``X-Priority`` header picks the class
  (``interactive`` | ``batch``); an interactive request may PREEMPT a
  batch-tier decode slot (router cancel + replay-with-history: the
  resumed stream is bit-identical).
- ``X-Request-Deadline: <seconds>`` maps onto ``generate(deadline_s=)``.
- Over quota / rate limited -> 429 with ``Retry-After``; capacity,
  deadline and failover sheds -> 503 with ``Retry-After`` and
  ``X-Shed-Cause``.
- A client that disconnects is REAPED: its request's cancel event sheds
  the router request (cause ``disconnect``) and the engine slot frees at
  the next tick boundary instead of decoding to an abandoned socket.
- Every response carries ``X-Request-Id``; an incoming W3C
  ``traceparent`` becomes the flight recorder's trace id.

The default :class:`ByteCodec` folds utf-8 bytes into the model vocab on
encode and renders token ids as space-joined integers on decode, so every
surface stays bit-checkable against the engine's ``generate()``.
``prompt`` may also be a list of token ids.

Where the port differs: the HTTP/1.1 server is the standard library's
``asyncio.start_server`` (serve/_http.py, shared with the serve proxy;
the JAX package's is aiohttp's). It reads a
``Content-Length`` body (over 64 MiB, aiohttp's ``client_max_size``:
413, refused before it is read; a ``Transfer-Encoding`` body: 501),
answers JSON with ``Content-Length`` and SSE in chunked transfer
encoding, serves sequential requests on a keep-alive connection, and
answers aiohttp's 404 / 405 texts for other paths and methods. A client
that went away is seen by a task that reads the connection while a
response is pending (EOF or a reset), or by a write that fails; either
sets the request's cancel event, on the blocking path as on the
streaming one. JAX's knobs ``RAY_TPU_GATEWAY_MAX_TOKENS`` (512) and
``RAY_TPU_GATEWAY_POOL`` (32) are the arguments ``max_tokens_cap`` and
``pool_size``; ``/v1/models`` says ``owned_by: "ray_tpu_torch"``.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ..observability import requests as reqtrace
from ._http import (_CLIENT_GONE, _CLOSED, HttpServer, _json_response,
                    _Request, _StreamResponse, _stop, _text_response)
from .autoscale import SlidingWindow
from .handle import RequestShedError
from .qos import (CLASSES, INTERACTIVE, QosGate, gateway_metrics,
                  push_gateway_event, push_gateway_stats, shed_outcome)

_GW_SEQ = itertools.count()
_log = logging.getLogger(__name__)

# the JAX package's knob defaults
MAX_TOKENS_CAP = 512
POOL_SIZE = 32
CLIENT_MAX_SIZE = 64 * 1024 * 1024

_SERVER = (f"Python/{sys.version_info[0]}.{sys.version_info[1]} "
           f"ray_tpu_torch-gateway")


class ByteCodec:
    """Deterministic toy text codec for tokenizer-less checkpoints:
    encode folds utf-8 bytes into ``[1, vocab)`` (id 0 is reserved),
    decode renders ids as space-joined integers. decode(encode(s)) is not
    the identity: the contract is determinism and prefix stability (the
    streamed deltas concatenate to exactly the non-streaming body)."""

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = max(3, int(vocab_size))

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        span = self.vocab_size - 1
        return [1 + (b % span) for b in data] or [1]

    def decode(self, tokens) -> str:
        return " ".join(str(int(t)) for t in tokens)


def _sse_frame(payload: Any) -> bytes:
    """One SSE data frame. Payloads are single-line JSON (json.dumps
    emits no raw newlines), so the one-line form is spec-compliant."""
    if isinstance(payload, bytes):
        data = payload
    elif isinstance(payload, str):
        data = payload.encode()
    else:
        data = json.dumps(payload, default=str).encode()
    return b"data: " + data + b"\n\n"


class GatewayServer:
    """One gateway replica: an HTTP server thread in front of one (or
    several, keyed by model name) DisaggRouter(s). Runs as an in-process
    object or an actor: the constructor only spawns a thread; ``ready()``
    blocks until the socket is bound."""

    def __init__(self, router: Any = None, *,
                 models: Optional[Dict[str, Any]] = None,
                 model: str = "ray-tpu",
                 qos: Optional[QosGate] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 eos_token: Optional[int] = None,
                 vocab_size: int = 32000,
                 codec: Any = None,
                 default_max_tokens: int = 16,
                 max_tokens_cap: int = MAX_TOKENS_CAP,
                 default_deadline_s: Optional[float] = None,
                 request_timeout_s: float = 120.0,
                 chaos_spec: Any = None,
                 replica: int = 0,
                 gateway_id: Optional[str] = None,
                 pool_size: int = POOL_SIZE):
        if models is None:
            if router is None:
                raise ValueError("need a router (or a models= table)")
            models = {model: router}
        self._models = dict(models)
        self._qos = qos
        self._host = host
        self._port = port
        self._eos_token = eos_token
        self._codec = codec or ByteCodec(vocab_size)
        self.default_max_tokens = int(default_max_tokens)
        self.max_tokens_cap = max(1, int(max_tokens_cap))
        self.default_deadline_s = default_deadline_s
        self.request_timeout_s = float(request_timeout_s)
        self.gateway_id = gateway_id or \
            f"gateway-{os.getpid()}-{next(_GW_SEQ)}"
        # scripted connection drops (resilience/chaos.py drop_connection
        # at=token:K | request:N): the monkey's exit_fn latches a flag;
        # the handler that crossed the count aborts ITS transport, which
        # the router sees exactly as a client that vanished
        from ..resilience.chaos import serve_monkey_from_spec

        self._chaos = serve_monkey_from_spec(
            chaos_spec, "gateway", replica, exit_fn=self._chaos_fire)
        self._chaos_fired = False
        self._lock = threading.Lock()
        self._stats: Dict[str, Any] = {
            "accepted": 0, "completed": 0, "streamed": 0,
            "disconnects": 0, "rate_limited": 0, "sheds": 0,
            "errors": 0, "preempt_dropped": 0, "tokens_out": 0,
        }
        self._by_class: Dict[str, Dict[str, int]] = {
            c: {"accepted": 0, "completed": 0, "shed": 0,
                "disconnects": 0} for c in CLASSES}
        self._by_code: Dict[str, int] = {}
        self._ttft_win: Dict[str, SlidingWindow] = {
            c: SlidingWindow() for c in CLASSES}
        self._last_push = 0.0
        self._pool = ThreadPoolExecutor(
            max_workers=int(pool_size),
            thread_name_prefix="gateway-generate")
        self._http = HttpServer(
            self._dispatch, host, port, name="gateway-http",
            server=_SERVER, label=f"gateway {self.gateway_id}",
            max_body=lambda: CLIENT_MAX_SIZE,
            on_bound=lambda: self.publish_telemetry(force=True))
        self._http.start()
        gateway_metrics()

    # --------------------------------------------------------- control

    def ready(self) -> tuple:
        return (self._host,
                self._http.wait_ready(30.0, "gateway HTTP server"))

    def stop(self) -> bool:
        """Close the listening socket and every open connection, stop
        the loop's thread and push the last snapshot."""
        self._http.stop()
        self._pool.shutdown(wait=False, cancel_futures=True)
        self.publish_telemetry(force=True)
        return True

    def _chaos_fire(self, _code: int) -> None:
        self._chaos_fired = True

    def _consume_chaos(self, hook: str, n: int = 1) -> bool:
        """Advance the chaos monkey's request / token counts; True when a
        drop_connection action fired on THIS call (handlers run on the
        one loop thread, so the attribution is race-free)."""
        if self._chaos is None:
            return False
        if hook == "request":
            self._chaos.on_request()
        else:
            self._chaos.on_tokens(n)
        if self._chaos_fired:
            self._chaos_fired = False
            return True
        return False

    def reset_chaos_counts(self) -> bool:
        if self._chaos is not None:
            self._chaos.reset_counts()
        return True

    # ------------------------------------------------------- accounting

    def _count(self, route: str, cls: str, code: int) -> None:
        with self._lock:
            key = str(code)
            self._by_code[key] = self._by_code.get(key, 0) + 1
            if code == 429:
                self._stats["rate_limited"] += 1
            elif code in (499,):
                self._stats["disconnects"] += 1
                if cls in self._by_class:
                    self._by_class[cls]["disconnects"] += 1
            elif code in (503,):
                self._stats["sheds"] += 1
                if cls in self._by_class:
                    self._by_class[cls]["shed"] += 1
            elif code >= 400:
                self._stats["errors"] += 1
        gateway_metrics()["requests"].inc(
            tags={"route": route, "class": cls, "code": str(code)})
        self.publish_telemetry()

    def _count_accept(self, route: str, cls: str,
                      tenant: Optional[str]) -> None:
        with self._lock:
            self._stats["accepted"] += 1
            if cls in self._by_class:
                self._by_class[cls]["accepted"] += 1
        push_gateway_event({"kind": "accept", "gateway": self.gateway_id,
                            "route": route, "class": cls,
                            "tenant": tenant})
        self.publish_telemetry()

    def _count_done(self, cls: str, n_tokens: int,
                    streamed: bool) -> None:
        with self._lock:
            self._stats["completed"] += 1
            self._stats["tokens_out"] += int(n_tokens)
            if streamed:
                self._stats["streamed"] += 1
            if cls in self._by_class:
                self._by_class[cls]["completed"] += 1

    def _first_byte(self, cls: str, ttft_ms: float) -> None:
        self._ttft_win.setdefault(cls, SlidingWindow()).add(ttft_ms)
        gateway_metrics()["ttft_ms"].observe(ttft_ms,
                                             tags={"class": cls})
        push_gateway_event({"kind": "first_byte",
                            "gateway": self.gateway_id, "class": cls,
                            "ttft_ms": round(ttft_ms, 3)})

    def _disconnected(self, route: str, cls: str, phase: str, tr,
                      tokens_sent: Optional[int] = None) -> None:
        """A client gone mid-request: 499, a disconnect marker, the
        trace's outcome."""
        self._count(route, cls, 499)
        ev = {"kind": "disconnect", "gateway": self.gateway_id,
              "class": cls, "phase": phase}
        attrs = {}
        if tokens_sent is not None:
            ev["tokens_sent"] = attrs["tokens_sent"] = tokens_sent
        push_gateway_event(ev)
        if tr is not None:
            tr.finish("disconnect", cause="client_gone", **attrs)

    def stats(self) -> Dict[str, Any]:
        """This replica's snapshot, the shape the conductor aggregates.
        ``preemptions`` reads the routers' own counter (the router fires
        preemptions, the gateway only causes them)."""
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
            s["by_class"] = {c: dict(v)
                             for c, v in self._by_class.items()}
            s["by_code"] = dict(self._by_code)
        preempt = 0
        for r in self._models.values():
            try:
                preempt += int(r.stats().get("preemptions", 0))
            except Exception:  # noqa: BLE001 — router mid-teardown
                pass
        s["preemptions"] = preempt
        s["role"] = "gateway"
        s["gateway_id"] = self.gateway_id
        s["host"] = self._host
        s["port"] = self._http.bound_port
        s["models"] = sorted(self._models)
        s["ttft_ms"] = {c: w.summary()
                        for c, w in self._ttft_win.items()}
        if self._qos is not None:
            s["qos"] = self._qos.stats()
        return s

    def publish_telemetry(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_push < 0.5:
            return
        self._last_push = now
        push_gateway_stats(self.gateway_id, self.stats())

    # ------------------------------------------------------ OpenAI shapes

    def _error_body(self, message: str, err_type: str,
                    code: Optional[str]) -> Dict[str, Any]:
        return {"error": {"message": message, "type": err_type,
                          "param": None, "code": code}}

    @staticmethod
    def _shed_status(e: RequestShedError) -> int:
        return 429 if getattr(e, "cause", None) in ("rate_limit",
                                                    "quota") else 503

    @staticmethod
    def _shed_headers(e: RequestShedError) -> Dict[str, str]:
        return {"Retry-After":
                str(max(1, int(getattr(e, "retry_after_s", 1.0)))),
                "X-Shed-Cause": str(getattr(e, "cause", "capacity"))}

    def _encode_prompt(self, body: Dict[str, Any],
                       route: str) -> List[int]:
        """OpenAI request -> token ids. Raises ValueError (-> 400)."""
        if route == "chat":
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ValueError("'messages' must be a non-empty list")
            parts = []
            for m in messages:
                if not isinstance(m, dict) or "content" not in m:
                    raise ValueError(
                        "each message needs 'role' and 'content'")
                parts.append(f"{m.get('role', 'user')}: {m['content']}")
            return self._codec.encode("\n".join(parts))
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return self._codec.encode(prompt)
        if isinstance(prompt, list) and prompt and \
                all(isinstance(t, int) for t in prompt):
            return [int(t) for t in prompt]
        raise ValueError(
            "'prompt' must be a string or a list of token ids")

    def _completion_payload(self, route: str, req_id: str,
                            created: int, model: str, text: str,
                            finish: Optional[str],
                            n_prompt: int, n_out: int,
                            chunk: bool = False,
                            first_chunk: bool = False
                            ) -> Dict[str, Any]:
        if route == "chat":
            if chunk:
                delta: Dict[str, Any] = {"content": text}
                if first_chunk:
                    delta["role"] = "assistant"
                choice: Dict[str, Any] = {"index": 0, "delta": delta,
                                          "finish_reason": finish}
                obj = "chat.completion.chunk"
            else:
                choice = {"index": 0,
                          "message": {"role": "assistant",
                                      "content": text},
                          "finish_reason": finish}
                obj = "chat.completion"
        else:
            choice = {"index": 0, "text": text,
                      "finish_reason": finish}
            obj = "text_completion"
        out = {"id": req_id, "object": obj, "created": created,
               "model": model, "choices": [choice]}
        if not chunk:
            out["usage"] = {"prompt_tokens": n_prompt,
                            "completion_tokens": n_out,
                            "total_tokens": n_prompt + n_out}
        return out

    # ------------------------------------------------------ the handlers

    async def _handle(self, request: _Request, route: str):
        """Parse, authenticate, admit, then the streaming or the blocking
        bridge. Every early exit counts into
        requests_total{route,class,code}; the class is "-" until the
        request names one."""
        cls = "-"
        tenant: Optional[str] = None
        admitted = False
        # the id is minted BEFORE parsing, so even a 400 carries an
        # X-Request-Id; an incoming traceparent bridges the caller's
        # trace id into the flight recorder
        t_req = time.perf_counter()
        req_id = (f"cmpl-{uuid.uuid4().hex[:24]}" if route != "chat"
                  else f"chatcmpl-{uuid.uuid4().hex[:24]}")
        request.req_id = req_id
        tp_in = request.headers.get("traceparent")
        try:
            try:
                body = json.loads(request.body or b"")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError):
                self._count(route, cls, 400)
                return _json_response(self._error_body(
                    "request body is not a valid JSON object",
                    "invalid_request_error", "invalid_json"),
                    status=400)
            model = body.get("model")
            if model is None and len(self._models) == 1:
                model = next(iter(self._models))
            router = self._models.get(model)
            if router is None:
                self._count(route, cls, 404)
                return _json_response(self._error_body(
                    f"model {model!r} does not exist",
                    "invalid_request_error", "model_not_found"),
                    status=404)
            auth = request.headers.get("Authorization", "")
            api_key = auth[7:] if auth.startswith("Bearer ") else None
            hint = request.headers.get("X-Tenant") or body.get("user")
            try:
                tenant = (self._qos.resolve(api_key, hint)
                          if self._qos is not None else hint)
            except PermissionError:
                self._count(route, cls, 401)
                return _json_response(self._error_body(
                    "invalid API key", "authentication_error",
                    "invalid_api_key"), status=401)
            requested_cls = (body.get("priority")
                             or request.headers.get("X-Priority"))
            try:
                if self._qos is not None:
                    cls = self._qos.classify(tenant, requested_cls)
                else:
                    cls = requested_cls or INTERACTIVE
                    if cls not in CLASSES:
                        raise ValueError(
                            f"unknown priority class {cls!r}")
                prompt_tokens = self._encode_prompt(body, route)
                max_tokens = int(body.get(
                    "max_tokens", self.default_max_tokens))
                max_tokens = max(1, min(max_tokens,
                                        self.max_tokens_cap))
                deadline_s = self.default_deadline_s
                hdr = request.headers.get("X-Request-Deadline")
                if hdr:
                    deadline_s = float(hdr)
                # router-side slow-client pacing (bench_serve's
                # backpressure knob): small checkpoints decode faster
                # than any real socket, so pacing scenarios need the
                # stream held open
                token_sleep_s = min(
                    1.0, max(0.0, float(body.get("token_sleep_s", 0))))
            except (TypeError, ValueError) as e:
                self._count(route, cls, 400)
                return _json_response(self._error_body(
                    str(e), "invalid_request_error", None), status=400)
            if self._qos is not None:
                try:
                    self._qos.admit(tenant, cls)
                    admitted = True
                except RequestShedError as e:
                    status = self._shed_status(e)
                    self._count(route, cls, status)
                    # a gate-shed request still leaves a trace: shed
                    # outcomes are always kept
                    tr = reqtrace.start_trace(
                        req_id, source="gateway", traceparent=tp_in,
                        tenant=tenant, cls=cls, t0=t_req)
                    if tr is not None:
                        tr.add_phase(
                            "qos_admission",
                            (time.perf_counter() - t_req) * 1e3)
                        tr.finish("shed",
                                  cause=getattr(e, "cause", None))
                    return _json_response(
                        self._error_body(str(e), "rate_limit_error",
                                         getattr(e, "cause", None)),
                        status=status, headers=self._shed_headers(e))
            self._count_accept(route, cls, tenant)
            if self._consume_chaos("request"):
                # scripted drop at admission: the socket dies before any
                # byte of the response
                request.conn.abort()
                self._count(route, cls, 499)
                return _CLOSED
            created = int(time.time())
            # t0 backdated to the handler's entry, so qos_admission
            # covers parse + auth + classify + admit
            tr = reqtrace.start_trace(
                req_id, source="gateway", traceparent=tp_in,
                tenant=tenant, cls=cls, t0=t_req)
            if tr is not None:
                tr.add_phase("qos_admission",
                             (time.perf_counter() - t_req) * 1e3)
            ctx = dict(route=route, cls=cls, tenant=tenant,
                       router=router, model=model or "",
                       prompt_tokens=prompt_tokens,
                       max_tokens=max_tokens, deadline_s=deadline_s,
                       token_sleep_s=token_sleep_s,
                       req_id=req_id, created=created, trace=tr)
            if body.get("stream"):
                return await self._stream_response(request, ctx)
            return await self._block_response(request, ctx)
        finally:
            if admitted:
                self._qos.release(tenant)

    def _generate_kwargs(self, ctx: Dict[str, Any]) -> Dict[str, Any]:
        kw = dict(eos_token=self._eos_token,
                  timeout_s=self.request_timeout_s,
                  deadline_s=ctx["deadline_s"],
                  token_sleep_s=ctx.get("token_sleep_s") or 0.0,
                  priority=ctx["cls"])
        # the tenant reaches the data plane only on a LoRA-enabled
        # deployment; an explicit tenant on a pool-less tier fails
        # loudly by design, so a plain deployment keeps the tenant at
        # the QoS layer
        router = ctx["router"]
        try:
            lora = bool(router._lora_enabled())
        except Exception:  # noqa: BLE001 — not a DisaggRouter
            lora = False
        if lora:
            kw["tenant"] = ctx["tenant"]
        return kw

    async def _block_response(self, request: _Request,
                              ctx: Dict[str, Any]):
        """Non-streaming bridge: the blocking generate runs on the
        executor pool, never on the loop; a client that goes away while
        it waits sets the cancel event, and the router sheds the decode
        through the same reap path as a mid-stream drop."""
        loop = asyncio.get_running_loop()
        route, cls = ctx["route"], ctx["cls"]
        router = ctx["router"]
        tr = ctx.get("trace")
        cancel_event = threading.Event()
        t0 = time.perf_counter()
        kwargs = self._generate_kwargs(ctx)
        kwargs["cancel_event"] = cancel_event

        def work():
            # activated on the EXECUTOR thread: the router's generate and
            # every in-process tier hop under it stamp this trace
            with reqtrace.activate(tr):
                return router.generate(ctx["prompt_tokens"],
                                       ctx["max_tokens"], **kwargs)

        fut = loop.run_in_executor(self._pool, work)
        # a request abandoned below still ends on the executor: its
        # outcome is read here so it is never reported as unretrieved
        fut.add_done_callback(
            lambda f: f.cancelled() or f.exception())
        gone = loop.create_future()
        request.conn.on_gone(
            lambda: gone.done() or gone.set_result(None))
        watcher = loop.create_task(request.conn.watch())
        try:
            await asyncio.wait({fut, gone},
                               return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:  # the gateway is stopping
            cancel_event.set()
            raise
        finally:
            await _stop(watcher)
        if not fut.done():
            # the client went away while the request waited
            cancel_event.set()
            self._disconnected(route, cls, "waiting", tr)
            return _CLOSED
        try:
            toks = fut.result()
        except RequestShedError as e:
            if request.conn.gone:
                self._disconnected(route, cls, "waiting", tr)
                return _CLOSED
            status = self._shed_status(e)
            self._count(route, cls, status)
            if tr is not None:
                outcome, cause = shed_outcome(e)
                tr.finish(outcome, cause=cause)
            return _json_response(
                self._error_body(str(e), "rate_limit_error"
                                 if status == 429 else "overloaded",
                                 getattr(e, "cause", None)),
                status=status, headers=self._shed_headers(e))
        except ValueError as e:
            self._count(route, cls, 400)
            if tr is not None:
                tr.finish("error", cause=type(e).__name__)
            return _json_response(self._error_body(
                str(e), "invalid_request_error", None), status=400)
        except Exception as e:  # noqa: BLE001 — surfaced as 500
            self._count(route, cls, 500)
            if tr is not None:
                tr.finish("error", cause=type(e).__name__)
            return _json_response(self._error_body(
                f"{type(e).__name__}: {e}", "api_error", None),
                status=500)
        self._first_byte(cls, (time.perf_counter() - t0) * 1e3)
        text = self._codec.decode(toks)
        finish = ("stop" if self._eos_token is not None and toks
                  and toks[-1] == int(self._eos_token) else "length")
        self._count_done(cls, len(toks), streamed=False)
        self._count(route, cls, 200)
        if tr is not None:
            tr.finish("ok", tokens=len(toks))
        return _json_response(self._completion_payload(
            route, ctx["req_id"], ctx["created"], ctx["model"], text,
            finish, len(ctx["prompt_tokens"]), len(toks)))

    async def _stream_response(self, request: _Request,
                               ctx: Dict[str, Any]):
        """SSE bridge: generate runs on the executor; its on_tokens
        chunks land on an asyncio queue (call_soon_threadsafe) and are
        re-framed as OpenAI stream chunks. Each delta is the decode of
        every token so far minus what was sent, so the concatenated
        deltas are EXACTLY the non-streaming body. A client gone (the
        watcher's EOF or reset, a failed write, a chaos drop) sets the
        cancel event; the router sheds the request with cause
        ``disconnect`` and the decode slot frees."""
        loop = asyncio.get_running_loop()
        route, cls = ctx["route"], ctx["cls"]
        router = ctx["router"]
        tr = ctx.get("trace")
        cancel_event = threading.Event()
        q: asyncio.Queue = asyncio.Queue()
        t0 = time.perf_counter()
        # sse_flush: wall time inside the writes, concurrent with decode
        # (the executor keeps generating while the loop flushes), so the
        # phase is marked concurrent and stays out of the phase sum
        flush_s = 0.0
        flush_n = 0

        def _put(item):
            try:
                loop.call_soon_threadsafe(q.put_nowait, item)
            except RuntimeError:  # the loop shut down mid-request
                cancel_event.set()

        kwargs = self._generate_kwargs(ctx)
        kwargs["cancel_event"] = cancel_event
        kwargs["on_tokens"] = lambda toks: _put(("tokens", list(toks)))

        def work():
            try:
                with reqtrace.activate(tr):
                    out = router.generate(ctx["prompt_tokens"],
                                          ctx["max_tokens"], **kwargs)
                _put(("done", out))
            except BaseException as e:  # noqa: BLE001 — relayed
                _put(("error", e))

        def _finish(outcome, cause=None, **attrs):
            if tr is None:
                return
            if flush_s > 0.0:
                tr.add_phase("sse_flush", flush_s * 1e3,
                             concurrent=True, writes=flush_n)
            tr.finish(outcome, cause=cause, **attrs)

        # the status line goes out with the FIRST frame: a request the
        # router sheds before producing anything (capacity, quota,
        # deadline) still gets a real 429 / 503 status; only a shed
        # mid-stream rides an SSE error frame
        resp = _StreamResponse(request, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Request-Id": ctx["req_id"]})
        request.conn.on_gone(lambda: q.put_nowait(("gone", None)))
        watcher = loop.create_task(request.conn.watch())
        self._pool.submit(work)
        got: List[int] = []
        sent_text = ""
        first = True
        disconnected = False
        failed: Optional[BaseException] = None
        try:
            while True:
                if request.conn.gone:
                    disconnected = True
                    break
                kind, payload = await q.get()
                if kind == "gone":
                    disconnected = True
                    break
                if kind == "tokens":
                    got.extend(payload)
                    text = self._codec.decode(got)
                    delta, sent_text = text[len(sent_text):], text
                    try:
                        t_w = time.perf_counter()
                        await resp.write(_sse_frame(
                            self._completion_payload(
                                route, ctx["req_id"], ctx["created"],
                                ctx["model"], delta, None, 0, 0,
                                chunk=True, first_chunk=first)))
                        flush_s += time.perf_counter() - t_w
                        flush_n += 1
                    except _CLIENT_GONE:
                        disconnected = True
                        break
                    if first:
                        first = False
                        self._first_byte(
                            cls, (time.perf_counter() - t0) * 1e3)
                    if self._consume_chaos("tokens", len(payload)):
                        request.conn.abort()
                        disconnected = True
                        break
                elif kind == "done":
                    toks = payload
                    finish = ("stop" if self._eos_token is not None
                              and toks
                              and toks[-1] == int(self._eos_token)
                              else "length")
                    try:
                        t_w = time.perf_counter()
                        await resp.write(_sse_frame(
                            self._completion_payload(
                                route, ctx["req_id"], ctx["created"],
                                ctx["model"], "", finish, 0, 0,
                                chunk=True)))
                        await resp.write(_sse_frame(b"[DONE]"))
                        await resp.write_eof()
                        flush_s += time.perf_counter() - t_w
                        flush_n += 1
                    except _CLIENT_GONE:
                        disconnected = True
                        break
                    self._count_done(cls, len(toks), streamed=True)
                    self._count(route, cls, 200)
                    _finish("ok", tokens=len(toks), streamed=True)
                    return resp
                else:  # an error relayed from the executor
                    failed = payload
                    break
        except asyncio.CancelledError:  # the gateway is stopping
            cancel_event.set()
            raise
        finally:
            await _stop(watcher)
        if disconnected:
            cancel_event.set()
            self._count(route, cls, 499)
            push_gateway_event({"kind": "disconnect",
                                "gateway": self.gateway_id,
                                "class": cls, "phase": "streaming",
                                "tokens_sent": len(got)})
            _finish("disconnect", cause="client_gone",
                    tokens_sent=len(got))
            return _CLOSED
        if isinstance(failed, RequestShedError):
            status = self._shed_status(failed)
            err_type = ("rate_limit_error" if status == 429
                        else "overloaded")
            headers = self._shed_headers(failed)
            outcome, cause = shed_outcome(failed)
            _finish(outcome, cause=cause)
        elif isinstance(failed, ValueError):
            status, err_type, headers = 400, "invalid_request_error", {}
            _finish("error", cause=type(failed).__name__)
        else:
            status, err_type, headers = 500, "api_error", {}
            _finish("error", cause=type(failed).__name__
                    if failed is not None else None)
        self._count(route, cls, status)
        body = self._error_body(str(failed), err_type,
                                getattr(failed, "cause", None))
        if not resp.prepared:
            # nothing on the wire yet: the shed gets a real status line,
            # the same shape as the non-streaming path
            return _json_response(body, status=status, headers=headers)
        # a failure mid-stream: the headers are long gone, so the event
        # stream ends with an error frame + [DONE] and a compliant client
        # stops reading instead of hanging
        try:
            await resp.write(_sse_frame(body))
            await resp.write(_sse_frame(b"[DONE]"))
            await resp.write_eof()
        except _CLIENT_GONE:
            return _CLOSED
        return resp

    # ------------------------------------------------------- HTTP server

    async def _models_listing(self, _request):
        return _json_response({
            "object": "list",
            "data": [{"id": m, "object": "model",
                      "owned_by": "ray_tpu_torch"}
                     for m in sorted(self._models)]})

    async def _healthz(self, _request):
        return _text_response("ok")

    async def _snapshot(self, _request):
        return _json_response(json.loads(
            json.dumps(self.stats(), default=str)))

    def _routes(self) -> Dict[str, Tuple[str, Any]]:
        return {
            "/v1/completions": (
                "POST", lambda r: self._handle(r, "completions")),
            "/v1/chat/completions": (
                "POST", lambda r: self._handle(r, "chat")),
            "/v1/models": ("GET", self._models_listing),
            "/-/healthz": ("GET", self._healthz),
            "/-/gateway": ("GET", self._snapshot),
        }

    async def _dispatch(self, request: _Request):
        route = self._routes().get(request.path)
        if route is None:
            return _text_response("404: Not Found", status=404)
        method, fn = route
        if request.method != method:
            return _text_response("405: Method Not Allowed", status=405,
                                  headers={"Allow": method})
        return await fn(request)


__all__ = ["ByteCodec", "GatewayServer"]
