"""Rollout buffer: the bounded, version-tagged queue between sampler
actors and the learner (port of ray_tpu/online/buffer.py).

The buffer is one actor holding rollout dicts (prompt and completion
token arrays, per-token scores, the weights version that produced them:
small host arrays, never device tensors). Flow control is explicit:

- ``put`` accepts up to the free capacity and rejects the rest (it
  returns the accepted count): a full buffer pushes back on the samplers,
  which pause generation and retry the same rollouts.
- ``get_batch`` pops FIFO, so two learner hosts pulling through
  ``streaming_split`` consume disjoint rollouts by construction.

:func:`from_rollouts` exposes the buffer through the streaming-split
contract `train.TorchTrainer(datasets=)` reads
(``streaming_split(world)[rank]``): each shard's ``iter_batches`` pulls
and collates the next batch on a background thread while the learner
steps on the current one. On shutdown, rollouts pulled but not yet
collated go back to the buffer; a collated batch waiting in the
prefetch queue is what a stopping learner drops.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import _notify
from .metrics import online_metrics


class RolloutBuffer:
    """Actor body of the rollout queue (``rt.remote(RolloutBuffer)
    .remote(capacity, name=...)``)."""

    def __init__(self, capacity: int = 256, name: str = "rollouts"):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self.name = name
        self._items: "collections.deque[Dict[str, Any]]" = \
            collections.deque()
        self._lock = threading.Lock()
        self.puts = 0
        self.rejected = 0
        self.gets = 0
        self.total_in = 0
        self.total_out = 0
        self._versions: Dict[int, int] = {}  # weights_version -> queued
        self._last_push = 0.0

    def put(self, rollouts: List[Dict[str, Any]]) -> int:
        """Enqueue up to the free capacity; the accepted count (0:
        full, hold on)."""
        with self._lock:
            free = self.capacity - len(self._items)
            accepted = rollouts[:max(0, free)]
            for r in accepted:
                self._items.append(r)
                v = r.get("weights_version")
                if v is not None:
                    self._versions[int(v)] = self._versions.get(int(v), 0) + 1
            self.puts += 1
            self.total_in += len(accepted)
            n_rej = len(rollouts) - len(accepted)
            self.rejected += n_rej
        if n_rej:
            online_metrics()["buffer_rejected"].inc(
                n_rej, tags={"buffer": self.name})
        self._publish_telemetry()
        return len(accepted)

    def get_batch(self, max_items: int) -> List[Dict[str, Any]]:
        """Pop up to `max_items` FIFO (non-blocking: the consumer owns
        its wait)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            while self._items and len(out) < max_items:
                r = self._items.popleft()
                v = r.get("weights_version")
                if v is not None:
                    left = self._versions.get(int(v), 0) - 1
                    if left > 0:
                        self._versions[int(v)] = left
                    else:
                        self._versions.pop(int(v), None)
                out.append(r)
            self.gets += 1
            self.total_out += len(out)
        self._publish_telemetry()
        return out

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"role": "buffer", "buffer": self.name,
                    "capacity": self.capacity,
                    "occupancy": len(self._items),
                    "puts": self.puts, "gets": self.gets,
                    "rejected": self.rejected,
                    "total_in": self.total_in, "total_out": self.total_out,
                    "versions_queued": dict(self._versions)}

    def _publish_telemetry(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_push < 0.25:
            return
        self._last_push = now
        st = self.stats()
        online_metrics()["buffer_occupancy"].set(
            st["occupancy"], tags={"buffer": self.name})
        _notify.push_stats(f"buffer/{self.name}", st)


# --------------------------------------------------- learner-side stream

class RolloutShard:
    """One learner host's iterator over the shared buffer (what
    ``get_dataset_shard`` returns). Destructive FIFO pops make shards
    disjoint."""

    def __init__(self, buffer: Any, *, batch_size: int,
                 min_items: Optional[int] = None,
                 poll_interval_s: float = 0.01,
                 collate_fn: Optional[Callable[[List[Dict[str, Any]]],
                                               Any]] = None,
                 prefetch: int = 1):
        self._buffer = buffer
        self.batch_size = int(batch_size)
        self.min_items = self.batch_size if min_items is None \
            else int(min_items)
        if not 0 < self.min_items <= self.batch_size:
            raise ValueError(
                f"min_items must be in [1, batch_size={self.batch_size}]"
                f", got {self.min_items}")
        self.poll_interval_s = poll_interval_s
        self._collate = collate_fn
        self._prefetch = max(0, int(prefetch))

    def _pull_batch(self, stop: Optional[threading.Event] = None) -> Any:
        """Accumulate min_items..batch_size rollouts (polling: the buffer
        never blocks its actor), then collate."""
        import ray_tpu_torch as rt

        items: List[Dict[str, Any]] = []
        while len(items) < self.min_items:
            if stop is not None and stop.is_set():
                if items:
                    # the pops were destructive: hand them back (a full
                    # buffer drops them)
                    try:
                        self._buffer.put.remote(items)
                    except Exception:  # noqa: BLE001 — buffer gone
                        pass
                return None
            got = rt.get(self._buffer.get_batch.remote(
                self.batch_size - len(items)), timeout=60.0)
            items.extend(got)
            if len(items) >= self.min_items:
                break
            time.sleep(self.poll_interval_s)
        return self._collate(items) if self._collate else items

    def iter_batches(self, **_ignored):
        """An endless batch stream; with prefetch the next batch is pulled
        and collated while the caller computes on the current one."""
        if self._prefetch == 0:
            while True:
                yield self._pull_batch()
        out: "_queue.Queue" = _queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def feed():
            try:
                while not stop.is_set():
                    batch = self._pull_batch(stop)
                    if batch is None:
                        return
                    while not stop.is_set():
                        try:
                            out.put(batch, timeout=0.2)
                            break
                        except _queue.Full:
                            continue
            except Exception as e:  # noqa: BLE001 — surfaced by the queue
                out.put(e)

        threading.Thread(target=feed, daemon=True,
                         name="rollout-prefetch").start()
        try:
            while True:
                batch = out.get()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()

    def count(self) -> int:
        import ray_tpu_torch as rt

        return rt.get(self._buffer.size.remote(), timeout=30.0)


class RolloutStream:
    """``datasets={"rollouts": from_rollouts(buffer)}``: the trainer calls
    ``streaming_split(world)`` and hands each rank one
    :class:`RolloutShard`."""

    def __init__(self, buffer: Any, *, batch_size: int = 8,
                 min_items: Optional[int] = None,
                 collate_fn: Optional[Callable] = None, prefetch: int = 1):
        self._buffer = buffer
        self._kw = dict(batch_size=batch_size, min_items=min_items,
                        collate_fn=collate_fn, prefetch=prefetch)

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List[RolloutShard]:
        return [RolloutShard(self._buffer, **self._kw) for _ in range(n)]

    @property
    def buffer(self) -> Any:
        return self._buffer


def from_rollouts(buffer: Any, *, batch_size: int = 8,
                  min_items: Optional[int] = None,
                  collate_fn: Optional[Callable] = None,
                  prefetch: int = 1) -> RolloutStream:
    """A :class:`RolloutBuffer` actor as a streaming-split dataset.
    `collate_fn(list_of_rollouts)` runs on the prefetch thread; without
    one, batches are lists of rollout dicts."""
    return RolloutStream(buffer, batch_size=batch_size, min_items=min_items,
                         collate_fn=collate_fn, prefetch=prefetch)


__all__ = ["RolloutBuffer", "RolloutShard", "RolloutStream",
           "from_rollouts"]
