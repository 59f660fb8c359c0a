"""Admission control's shed error and the serving plane's in-process
counters (part of the port of ray_tpu/serve/handle.py).

`RequestShedError` is what a router raises instead of queueing past its
bound, with the client's backoff hint and the shed's cause.
`shed_counter()` counts every shed of this process by (app,
deployment). The JAX package registers these counters, and the
disaggregated-serving and KV-plane families, with Prometheus; the port
keeps them in this process (`Counter`, `Gauge`: `value()`,
`snapshot()`) until `util/metrics.py` is ported.

Not ported with it: the serve deployments' `Router`, handles and the
controller (ROADMAP Queue 1).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple


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


class Counter:
    """A monotonic in-process counter, one value per tag set."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    @staticmethod
    def _key(tags: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v))
                            for k, v in (tags or {}).items()))

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, Any]] = None) -> None:
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(value)

    def value(self, tags: Optional[Dict[str, Any]] = None) -> float:
        """The value of one tag set; with no tags, the sum of all."""
        with self._lock:
            if tags is None:
                return sum(self._values.values())
            return self._values.get(self._key(tags), 0.0)

    def snapshot(self) -> Dict[str, float]:
        """{"k=v,k=v": value} for every tag set seen."""
        with self._lock:
            return {",".join(f"{k}={v}" for k, v in key): val
                    for key, val in self._values.items()}


class Gauge(Counter):
    """A last-value in-process gauge, one value per tag set."""

    def set(self, value: float, tags: Optional[Dict[str, Any]] = None
            ) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


_shed_counter: Optional[Counter] = None
_shed_lock = threading.Lock()


def shed_counter() -> Counter:
    """This process's shed counter (JAX: ``ray_tpu_serve_shed_total``),
    shared by every router so it covers every shed path."""
    global _shed_counter
    with _shed_lock:
        if _shed_counter is None:
            _shed_counter = Counter(
                "ray_tpu_serve_shed_total",
                "requests rejected by admission control",
                tag_keys=("app", "deployment"))
        return _shed_counter


__all__ = ["Counter", "Gauge", "RequestShedError", "shed_counter"]
