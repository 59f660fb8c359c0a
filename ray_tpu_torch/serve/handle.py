"""Admission control's shed error and its counter (part of the port of
ray_tpu/serve/handle.py).

`RequestShedError` is what a router raises instead of queueing past its
bound, with the client's backoff hint and the shed's cause.
`shed_counter()` counts every shed of this process by (app,
deployment): ``ray_tpu_serve_shed_total`` on `util.metrics`, created on
first use.

Not ported with it: the serve deployments' `Router`, handles and the
controller (ROADMAP Queue 1).
"""
from __future__ import annotations

import threading
from typing import Any, Optional


class RequestShedError(RuntimeError):
    """Admission control's rejection: shed BEFORE the engine wedges.
    ``retry_after_s`` is the client's backoff hint; ``cause`` attributes
    the shed: ``capacity`` (the admission bound), ``deadline`` (the
    request outlived its deadline_s), ``failover`` (replica deaths used up
    the bounded retry budget), ``draining``, ``disconnect``."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 cause: str = "capacity"):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.cause = str(cause)

    def __reduce__(self):
        return (type(self), (str(self), self.retry_after_s, self.cause))


_shed_counter: Optional[Any] = None
_shed_lock = threading.Lock()


def shed_counter() -> Any:
    """This process's ``ray_tpu_serve_shed_total`` counter (JAX's name,
    help and tags), shared by every router so it covers every shed
    path."""
    global _shed_counter
    with _shed_lock:
        if _shed_counter is None:
            from ..util.metrics import Counter

            _shed_counter = Counter(
                "ray_tpu_serve_shed_total",
                "requests rejected by admission control (queue depth "
                "past the knob)",
                tag_keys=("app", "deployment"))
        return _shed_counter


__all__ = ["RequestShedError", "shed_counter"]
