"""Model multiplexing (the port of ray_tpu/serve/multiplex.py) — the
reference's python/ray/serve/multiplex.py (_ModelMultiplexWrapper) +
api.py (@serve.multiplexed, get_multiplexed_model_id).

A replica hosts up to N models, loaded on demand and evicted LRU; an
evicted model's ``shutdown()`` hook, if it has one, runs at eviction
(e.g. to free its CUDA tensors at once)."""
from __future__ import annotations

import collections
import functools
import threading
from typing import Any, Callable, Optional

from .context import get_request_context


def get_multiplexed_model_id() -> str:
    """The model id of the current request (from the
    'serve_multiplexed_model_id' header or handle option) — reference
    python/ray/serve/api.py get_multiplexed_model_id."""
    return get_request_context().multiplexed_model_id


def request_tenant() -> Optional[str]:
    """The current serve request's multiplexed-model-id, reused as the
    multi-tenant LoRA tenant tag (serve/lora.py): a deployment that
    already routes per-model via ``@serve.multiplexed`` gets per-tenant
    adapter serving with no new request plumbing —
    ``DisaggRouter.generate`` defaults its ``tenant=`` to this. None
    outside a request context or when the request carries no id."""
    try:
        mid = get_request_context().multiplexed_model_id
    except Exception:  # noqa: BLE001 — no request context here
        return None
    return mid or None


class _ModelCache:
    def __init__(self, loader: Callable[[Any, str], Any], max_models: int):
        self._loader = loader
        self._max = max_models
        self._cache: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def __reduce__(self):
        # Per-process state (lock, loaded models) is rebuilt in the replica.
        return (_ModelCache, (self._loader, self._max))

    def get(self, self_arg, model_id: str) -> Any:
        with self._lock:
            if model_id in self._cache:
                self._cache.move_to_end(model_id)
                return self._cache[model_id]
        model = (self._loader(self_arg, model_id) if self_arg is not None
                 else self._loader(model_id))
        with self._lock:
            self._cache[model_id] = model
            self._cache.move_to_end(model_id)
            while len(self._cache) > self._max:
                old_id, old = self._cache.popitem(last=False)
                # Optional eviction hook (e.g. free CUDA tensors eagerly);
                # plain models are simply dropped for GC.
                shutdown_fn = getattr(old, "shutdown", None)
                if callable(shutdown_fn):
                    try:
                        shutdown_fn()
                    except Exception:  # noqa: BLE001 — eviction best-effort
                        pass
        return model

    def model_ids(self):
        with self._lock:
            return list(self._cache.keys())


def multiplexed(_fn: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator on a model-loading method ``def get_model(self, model_id)``;
    calls are LRU-cached per replica."""

    def deco(fn: Callable) -> Callable:
        from .batching import PerInstance
        caches = PerInstance(
            lambda: _ModelCache(fn, max_num_models_per_replica))

        @functools.wraps(fn)
        def wrapper(*args):
            if len(args) == 2:
                self_arg, model_id = args
            else:
                self_arg, model_id = None, args[0]
            return caches.get(self_arg).get(self_arg, model_id)

        wrapper._serve_model_caches = caches
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
