"""User-defined metrics (the port's copy of the JAX package's
util/metrics.py) — analog of the reference's
python/ray/util/metrics.py (Counter/Gauge/Histogram riding the OpenCensus →
metrics-agent → Prometheus pipeline, src/ray/stats/metric.h:103). Here every
process keeps a registry and pushes snapshots to the conductor
(report_metrics); ray_tpu_torch.util.state.prometheus_metrics() renders
the aggregate in Prometheus text exposition format. The push interval is
the registry's argument (JAX's default, 2 s), where the JAX package
reads a knob."""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

_DEFAULT_PUSH_INTERVAL_S = 2.0


class _Registry:
    def __init__(self, push_interval_s: float = _DEFAULT_PUSH_INTERVAL_S):
        if push_interval_s <= 0:
            raise ValueError("push_interval_s must be positive")
        self.push_interval_s = push_interval_s
        self._metrics: List["Metric"] = []
        self._lock = threading.Lock()
        self._pusher_started = False
        self._stop_event = threading.Event()

    def register(self, m: "Metric") -> None:
        with self._lock:
            self._metrics.append(m)
        self._ensure_pusher()

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [m._snapshot() for m in self._metrics]

    def _ensure_pusher(self) -> None:
        with self._lock:
            if self._pusher_started:
                return
            self._pusher_started = True
            # restartable: a fresh event per pusher generation, so a
            # cluster started after shutdown() gets a live push loop
            self._stop_event = stop = threading.Event()

        def push_loop():
            from .._private import worker as worker_mod

            while not stop.wait(self.push_interval_s):
                w = worker_mod.global_worker
                if w is None:
                    continue
                try:
                    w.conductor.notify("report_metrics", w.worker_id,
                                       self.snapshot())
                except Exception:  # noqa: BLE001 — cluster shutting down
                    pass

        threading.Thread(target=push_loop, daemon=True,
                         name="metrics-push").start()

    def flush(self) -> None:
        """Push immediately (tests / pre-shutdown)."""
        from .._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is not None:
            w.conductor.notify("report_metrics", w.worker_id, self.snapshot())

    def stop(self) -> None:
        """Stop the push loop and push one final snapshot — called from
        ray_tpu_torch.shutdown() so the last interval's increments are not
        lost (the seed's `while True` daemon just died with the
        process). register() after stop() restarts the loop."""
        with self._lock:
            self._stop_event.set()
            self._pusher_started = False
        try:
            self.flush()
        except Exception:  # noqa: BLE001 — conductor already gone
            pass


_registry = _Registry()


class Metric:
    """Base — reference util/metrics.py Metric."""

    _type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        unknown = set(tags) - set(self._tag_keys)
        if unknown:
            raise ValueError(f"unknown tag keys {sorted(unknown)}")
        self._default_tags = dict(tags)
        return self

    def _tag_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        merged = dict(self._default_tags)
        if tags:
            unknown = set(tags) - set(self._tag_keys)
            if unknown:
                raise ValueError(f"unknown tag keys {sorted(unknown)}")
            merged.update(tags)
        return tuple(merged.get(k, "") for k in self._tag_keys)

    @staticmethod
    def _encode_tags(k: Tuple[str, ...]) -> str:
        # json, not ','.join: tag values may themselves contain commas
        import json
        return json.dumps(list(k))

    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"name": self.name, "type": self._type,
                    "description": self.description,
                    "tag_keys": self._tag_keys,
                    "values": {self._encode_tags(k): v
                               for k, v in self._values.items()}}


class Counter(Metric):
    _type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = self._tag_tuple(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    _type = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        k = self._tag_tuple(tags)
        with self._lock:
            self._values[k] = float(value)


class Histogram(Metric):
    """Bucketed histogram — exposition emits _bucket/_sum/_count series."""

    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1.0, 10.0, 100.0])
        self._buckets: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._counts: Dict[Tuple[str, ...], int] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        k = self._tag_tuple(tags)
        with self._lock:
            b = self._buckets.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            i = 0
            while i < len(self.boundaries) and value > self.boundaries[i]:
                i += 1
            b[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"name": self.name, "type": self._type,
                    "description": self.description,
                    "tag_keys": self._tag_keys,
                    "boundaries": self.boundaries,
                    "buckets": {self._encode_tags(k): v
                                for k, v in self._buckets.items()},
                    "sums": {self._encode_tags(k): v
                             for k, v in self._sums.items()},
                    "counts": {self._encode_tags(k): v
                               for k, v in self._counts.items()}}


def flush() -> None:
    _registry.flush()


def shutdown() -> None:
    """Stop the push loop + final flush (ray_tpu_torch.shutdown() hook)."""
    _registry.stop()
