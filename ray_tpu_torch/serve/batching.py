"""Dynamic request batching (the port of ray_tpu/serve/batching.py) —
the reference's python/ray/serve/batching.py (@serve.batch).

A decorated method receives a *list* of inputs; callers enqueue single
inputs and a background flusher invokes the underlying function once per
batch (whichever of max_batch_size / batch_wait_timeout_s is hit first),
so a replica runs one batched forward pass on the card instead of one
call per request."""
from __future__ import annotations

import functools
import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

# Batch-occupancy telemetry: the whole point of @serve.batch is keeping
# the device fed, so the flushed batch size (and its fraction of
# max_batch_size) is the gauge that says whether it is working. One set
# of metric objects per process; batchers are distinguished by the "fn"
# label.
_metrics_cache: Dict[str, Any] = {}
_metrics_lock = threading.Lock()


def _batch_metrics() -> Dict[str, Any]:
    # double-checked init: unlocked fast path per flush; the lock only
    # guards first-time registration so concurrent batcher flush threads
    # cannot register duplicate metric objects
    if _metrics_cache:
        return _metrics_cache
    with _metrics_lock:
        if not _metrics_cache:
            _build_metrics()
    return _metrics_cache


def _build_metrics() -> None:
    from ..util.metrics import Gauge, Histogram

    _metrics_cache.update(
        size=Histogram(
            "serve_batch_size", "flushed batch sizes",
            boundaries=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0],
            tag_keys=("fn",)),
        occupancy=Gauge(
            "serve_batch_occupancy",
            "last flushed batch size / max_batch_size",
            tag_keys=("fn",)),
        queue_depth=Gauge(
            "serve_batch_queue_depth",
            "items waiting in the batcher queue",
            tag_keys=("fn",)))


class PerInstance:
    """Lazily builds one state object per bound instance (weakly held), so a
    decorated *class* doesn't share one batcher/cache across instances —
    the reference attaches these to self lazily for the same reason
    (serve/batching.py _get_or_create_batch_queue)."""

    def __init__(self, factory: Callable[[], Any]):
        self._factory = factory
        self._lock = threading.Lock()
        self._by_instance: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._default: Optional[Any] = None

    def get(self, self_arg: Optional[Any]) -> Any:
        with self._lock:
            if self_arg is None:
                if self._default is None:
                    self._default = self._factory()
                return self._default
            obj = self._by_instance.get(self_arg)
            if obj is None:
                obj = self._factory()
                self._by_instance[self_arg] = obj
            return obj

    def __reduce__(self):
        # Locks/weakrefs are per-process; rebuild empty in the replica.
        return (PerInstance, (self._factory,))


class _BatchQueue:
    def __init__(self, fn: Callable[..., List[Any]], max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._max_batch_size = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def __reduce__(self):
        # Queues/locks/threads are per-process state — rebuild fresh in the
        # replica rather than pickling them with the deployment class.
        return (_BatchQueue,
                (self._fn, self._max_batch_size, self._timeout))

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name="serve-batcher")
                self._thread.start()

    def submit(self, self_arg, item) -> Future:
        fut: Future = Future()
        self._queue.put((self_arg, item, fut))
        self._ensure_thread()
        return fut

    def _flush_loop(self):
        while True:
            batch = [self._queue.get()]  # block for the first item
            try:
                while len(batch) < self._max_batch_size:
                    batch.append(self._queue.get(timeout=self._timeout))
            except queue.Empty:
                pass
            self._run_batch(batch)

    def _run_batch(self, batch):
        self_arg = batch[0][0]
        items = [b[1] for b in batch]
        futs = [b[2] for b in batch]
        try:
            m = _batch_metrics()
            tags = {"fn": getattr(self._fn, "__name__", "batch")}
            m["size"].observe(float(len(items)), tags=tags)
            m["occupancy"].set(len(items) / max(1, self._max_batch_size),
                               tags=tags)
            m["queue_depth"].set(self._queue.qsize(), tags=tags)
        except Exception:  # noqa: BLE001 — telemetry must not fail a batch
            pass
        try:
            if self_arg is not None:
                results = self._fn(self_arg, items)
            else:
                results = self._fn(items)
            if not isinstance(results, list) or len(results) != len(items):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"{len(items)} results, got {type(results).__name__}")
            for f, r in zip(futs, results):
                f.set_result(r)
        except Exception as e:  # noqa: BLE001 — fan the error out to callers
            for f in futs:
                if not f.done():
                    f.set_exception(e)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: turn a method taking List[T] -> List[R] into one taking a
    single T (returns R), with dynamic batching across concurrent callers.
    Reference python/ray/serve/batching.py:@serve.batch."""

    def deco(fn: Callable) -> Callable:
        queues = PerInstance(
            lambda: _BatchQueue(fn, max_batch_size, batch_wait_timeout_s))

        @functools.wraps(fn)
        def wrapper(*args):
            # Method (self, item) or free function (item).
            if len(args) == 2:
                self_arg, item = args
            elif len(args) == 1:
                self_arg, item = None, args[0]
            else:
                raise TypeError("@serve.batch functions take one argument")
            return queues.get(self_arg).submit(self_arg, item).result()

        wrapper._serve_batch_queues = queues  # introspection/tests
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
