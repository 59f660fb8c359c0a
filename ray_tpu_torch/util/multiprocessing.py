"""multiprocessing.Pool drop-in over ray_tpu_torch tasks (the port's copy
of the JAX package's shim, unchanged but for the package) — analog of the
reference's python/ray/util/multiprocessing/ (Pool on actor pool). Work
items become tasks (shared worker processes), so a Pool costs nothing when
idle and parallelism is bounded by cluster CPUs, not pool size."""
from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional


class AsyncResult:
    """multiprocessing.pool.AsyncResult-compatible wrapper."""

    def __init__(self, refs, single: bool, callback=None,
                 error_callback=None):
        self._refs = refs
        self._single = single
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        # callbacks must be assigned before the waiter thread starts:
        # fast-resolving refs otherwise race _wait_bg reading them
        self._callback = callback
        self._error_callback = error_callback
        threading.Thread(target=self._wait_bg, daemon=True).start()

    def _wait_bg(self):
        import ray_tpu_torch as rt

        try:
            values = rt.get(list(self._refs))
            self._value = values[0] if self._single else values
            if self._callback is not None:
                self._callback(self._value)
        except BaseException as e:  # noqa: BLE001
            self._error = e
            if self._error_callback is not None:
                self._error_callback(e)
        finally:
            self._done.set()

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("not ready")
        return self._error is None

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value


class Pool:
    """``from ray_tpu_torch.util.multiprocessing import Pool`` — the
    reference's drop-in (util/multiprocessing/pool.py). `processes` only bounds chunked
    map fan-out; scheduling is cluster-wide."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        import ray_tpu_torch as rt

        if not rt.is_initialized():
            rt.init(ignore_reinit_error=True)
        self._processes = processes or int(
            rt.cluster_resources().get("CPU", 1))
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

    def _task(self, func):
        import ray_tpu_torch as rt

        init, initargs = self._initializer, self._initargs

        def call(*args, **kwargs):
            if init is not None:
                init(*initargs)
            return func(*args, **kwargs)

        return rt.remote(call)

    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    # -- apply ---------------------------------------------------------------
    def apply(self, func, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args: tuple = (),
                    kwds: Optional[dict] = None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check()
        ref = self._task(func).remote(*args, **(kwds or {}))
        return AsyncResult([ref], single=True, callback=callback,
                           error_callback=error_callback)

    # -- map -----------------------------------------------------------------
    def _chunks(self, iterable: Iterable,
                chunksize: Optional[int]) -> List[List[Any]]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], chunksize

    def map(self, func, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable: Iterable,
                  chunksize: Optional[int] = None, callback=None,
                  error_callback=None) -> AsyncResult:
        self._check()
        chunks, _ = self._chunks(iterable, chunksize)

        def run_chunk(chunk):
            return [func(x) for x in chunk]

        refs = [self._task(run_chunk).remote(c) for c in chunks]

        class _FlatResult(AsyncResult):
            def _wait_bg(inner):
                import ray_tpu_torch as rt

                try:
                    nested = rt.get(list(inner._refs))
                    inner._value = list(
                        itertools.chain.from_iterable(nested))
                    if inner._callback is not None:
                        inner._callback(inner._value)
                except BaseException as e:  # noqa: BLE001
                    inner._error = e
                    if inner._error_callback is not None:
                        inner._error_callback(e)
                finally:
                    inner._done.set()

        return _FlatResult(refs, single=False, callback=callback,
                           error_callback=error_callback)

    def starmap(self, func, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        return self.map(lambda args: func(*args), list(iterable), chunksize)

    def imap(self, func, iterable: Iterable,
             chunksize: Optional[int] = None):
        import ray_tpu_torch as rt

        chunks, _ = self._chunks(iterable, chunksize)

        def run_chunk(chunk):
            return [func(x) for x in chunk]

        refs = [self._task(run_chunk).remote(c) for c in chunks]
        for ref in refs:  # ordered, lazily fetched
            yield from rt.get(ref)

    def imap_unordered(self, func, iterable: Iterable,
                       chunksize: Optional[int] = None):
        import ray_tpu_torch as rt

        chunks, _ = self._chunks(iterable, chunksize)

        def run_chunk(chunk):
            return [func(x) for x in chunk]

        pending = [self._task(run_chunk).remote(c) for c in chunks]
        while pending:
            done, pending = rt.wait(pending, num_returns=1)
            yield from rt.get(done[0])

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *a) -> None:
        self.terminate()
