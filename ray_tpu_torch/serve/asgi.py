"""ASGI ingress adapter — `@serve.ingress(asgi_app)` (the port of
ray_tpu/serve/asgi.py).

Reference: python/ray/serve/api.py `ingress` + _private/http_util.py
ASGIAppReplicaWrapper: a deployment class decorated with an ASGI
application (FastAPI, Starlette, or any bare `async def app(scope,
receive, send)`) serves every HTTP request routed to it through that
app. The proxy already parsed the request, so the adapter speaks the
ASGI `http.request` / `http.response.*` messages directly: no server
dependency, any spec-compliant app.
"""
from __future__ import annotations

from typing import Any, Callable

from .http_util import Request, Response


def _build_scope(request: Request, root_path: str = "") -> dict:
    path = request.path
    return {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "scheme": "http",
        "path": path,
        "raw_path": path.encode(),
        # the deployment's route prefix: frameworks route on
        # path[len(root_path):], so @app.get("/hello") matches under
        # route_prefix="/api" (reference sets root_path the same way)
        "root_path": root_path,
        "query_string": request.query_string.encode(),
        "headers": [(k.lower().encode(), v.encode())
                    for k, v in request.headers.items()],
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
    }


async def _run_asgi(app: Callable, request: Request,
                    root_path: str = "") -> Response:
    body_sent = False

    async def receive():
        nonlocal body_sent
        if body_sent:
            # the request body was fully delivered; a second receive()
            # means the app is waiting for the connection to close
            return {"type": "http.disconnect"}
        body_sent = True
        return {"type": "http.request", "body": request.body,
                "more_body": False}

    out = {"status": 200, "headers": [], "body": bytearray()}

    async def send(message):
        if message["type"] == "http.response.start":
            out["status"] = message["status"]
            out["headers"] = list(message.get("headers", []))
        elif message["type"] == "http.response.body":
            out["body"] += message.get("body", b"")

    await app(_build_scope(request, root_path), receive, send)
    headers = [(k.decode("latin-1"), v.decode("latin-1"))
               for k, v in out["headers"]]  # pairs: duplicates survive
    return Response(bytes(out["body"]), status=out["status"],
                    headers=headers)


def ingress(asgi_app: Any) -> Callable[[type], type]:
    """Class decorator: route this deployment's HTTP traffic through
    `asgi_app` — any ASGI-3 callable, including a bare
    ``async def app(scope, receive, send)``, a Starlette app, or a
    FastAPI app whose routes are module-level functions:

        app = FastAPI()

        @app.get("/hello")
        def hello():
            return "hi"

        @serve.deployment
        @serve.ingress(app)
        class Api:
            pass

    Unlike the reference's make_fastapi_class_based_view, routes defined
    as METHODS of the deployment class (taking ``self``) are NOT bound —
    keep FastAPI/Starlette routes self-less, with per-replica state on
    the class reachable via closure or app.state if needed.
    """
    def decorator(cls: type) -> type:
        if not isinstance(cls, type):
            raise TypeError("@serve.ingress decorates a class (apply it "
                            "under @serve.deployment)")

        class ASGIIngressWrapper(cls):  # type: ignore[misc, valid-type]
            async def __call__(self, request: Request) -> Response:
                from .context import get_request_context

                prefix = get_request_context().route
                root = "" if prefix in ("", "/") \
                    else prefix.rstrip("/")
                return await _run_asgi(asgi_app, request, root)

        ASGIIngressWrapper.__name__ = cls.__name__
        ASGIIngressWrapper.__qualname__ = getattr(cls, "__qualname__",
                                                  cls.__name__)
        ASGIIngressWrapper.__module__ = cls.__module__
        ASGIIngressWrapper.__asgi_app__ = asgi_app
        return ASGIIngressWrapper

    return decorator


__all__ = ["ingress", "Response"]
