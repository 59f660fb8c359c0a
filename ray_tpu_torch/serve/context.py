"""Per-request context (the port of ray_tpu/serve/context.py) — the
reference's python/ray/serve/context.py _serve_request_context
contextvar."""
from __future__ import annotations

import contextvars
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class RequestContext:
    route: str = ""
    request_id: str = ""
    app_name: str = ""
    multiplexed_model_id: str = ""
    headers: Dict[str, str] = field(default_factory=dict)


_request_context: contextvars.ContextVar[RequestContext] = \
    contextvars.ContextVar("serve_request_context", default=RequestContext())


def get_request_context() -> RequestContext:
    return _request_context.get()


def set_request_context(ctx: RequestContext):
    return _request_context.set(ctx)
