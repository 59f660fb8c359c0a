"""The HTTP request and response that cross the proxy -> replica actor
boundary (the port of ray_tpu/serve/http_util.py; the reference's
python/ray/serve/_private/http_util.py adapts Starlette). Both are plain
and picklable, so no ASGI dependency rides along."""
from __future__ import annotations

import json as _json
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl


class Request:
    """What an ingress deployment's __call__ receives for HTTP requests."""

    def __init__(self, method: str, path: str, query_string: str = "",
                 headers: Optional[Dict[str, str]] = None,
                 body: bytes = b""):
        self.method = method
        self.path = path
        self.query_string = query_string
        self.headers = dict(headers or {})
        self.body = body

    @property
    def query_params(self) -> Dict[str, str]:
        return dict(parse_qsl(self.query_string))

    def json(self) -> Any:
        return _json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode("utf-8", "replace")

    def __repr__(self):
        return f"Request({self.method} {self.path})"


class Response:
    """Explicit HTTP response with header control (the tuple/str/dict
    shorthands cannot carry headers) — what the ASGI ingress adapter
    returns, and available to plain deployments too.

    `headers` may be a dict or a list of (name, value) pairs; the list
    form preserves duplicates (multiple Set-Cookie headers)."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, body: Any = b"", status: int = 200,
                 headers: Any = None):
        self.status = int(status)
        if headers is None:
            self.headers: List[Tuple[str, str]] = []
        elif isinstance(headers, dict):
            self.headers = [(str(k), str(v)) for k, v in headers.items()]
        else:
            self.headers = [(str(k), str(v)) for k, v in headers]
        if isinstance(body, str):
            body = body.encode()
        elif not isinstance(body, (bytes, bytearray)):
            body = _json.dumps(body, default=str).encode()
        self.body = bytes(body)


def coerce_response(result: Any) -> Tuple[int, Any, bytes]:
    """Map a user return value to (status, headers, body) the way the
    reference proxy does for Starlette responses / raw returns. Headers
    come back as a dict for the shorthand forms and as a list of pairs
    (duplicate-preserving) for Response objects."""
    if isinstance(result, Response):
        return result.status, result.headers, result.body
    if isinstance(result, tuple) and len(result) == 2 and \
            isinstance(result[0], int):
        status, payload = result
    else:
        status, payload = 200, result
    if isinstance(payload, bytes):
        return status, {"content-type": "application/octet-stream"}, payload
    if isinstance(payload, str):
        return status, {"content-type": "text/plain; charset=utf-8"}, \
            payload.encode()
    return status, {"content-type": "application/json"}, \
        _json.dumps(payload, default=str).encode()
