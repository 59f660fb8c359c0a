"""ActorPool (the port's copy of the JAX package's, unchanged but for
the package) — API of the reference's python/ray/util/actor_pool.py:
map/submit over a fixed set of actors with free/busy bookkeeping."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor = {}
        self._pending_submits: List[tuple] = []

    def submit(self, fn: Callable, value: Any) -> None:
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref.id] = (ref, actor)
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def get_next(self, timeout: float = None) -> Any:
        import ray_tpu_torch as rt

        if not self._future_to_actor:
            raise StopIteration("no pending results")
        refs = [ref for ref, _ in self._future_to_actor.values()]
        ready, _ = rt.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next timed out")
        ref = ready[0]
        _, actor = self._future_to_actor.pop(ref.id)
        self._return_actor(actor)
        return rt.get(ref)

    def get_next_unordered(self, timeout: float = None) -> Any:
        return self.get_next(timeout)

    def _return_actor(self, actor) -> None:
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            ref = fn(actor, value)
            self._future_to_actor[ref.id] = (ref, actor)
        else:
            self._idle.append(actor)

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        return self.map(fn, values)

    def has_free(self) -> bool:
        return bool(self._idle)
