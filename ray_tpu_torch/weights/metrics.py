"""The weight fabric's Prometheus families (port of
ray_tpu/weights/metrics.py), on ``util.metrics`` and created on first
use, so importing ``ray_tpu_torch.weights`` starts no metrics pusher:

- ray_tpu_weights_publish_ms{name}            publish latency (shards put
                                              + registry commit)
- ray_tpu_weights_published_total{name}       versions published
- ray_tpu_weights_fetched_bytes_total{name}   chunk bytes pulled by this
                                              process
- ray_tpu_weights_fetches_total{name}         version fetches completed
- ray_tpu_weights_staleness_versions{name,consumer}
                                              latest published version
                                              minus the one served
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_metrics: Optional[Dict[str, Any]] = None
_lock = threading.Lock()

_PUBLISH_BOUNDS_MS = [1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0]


def weight_metrics() -> Dict[str, Any]:
    global _metrics
    m = _metrics
    if m is not None:
        return m
    with _lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge, Histogram

            _metrics = dict(
                publish_ms=Histogram(
                    "ray_tpu_weights_publish_ms",
                    "weight publish latency: local shards into the "
                    "object store + registry commit",
                    boundaries=_PUBLISH_BOUNDS_MS, tag_keys=("name",)),
                published=Counter(
                    "ray_tpu_weights_published_total",
                    "weight versions published", tag_keys=("name",)),
                fetched_bytes=Counter(
                    "ray_tpu_weights_fetched_bytes_total",
                    "weight chunk bytes fetched by this process",
                    tag_keys=("name",)),
                fetches=Counter(
                    "ray_tpu_weights_fetches_total",
                    "weight version fetches completed by this process",
                    tag_keys=("name",)),
                staleness=Gauge(
                    "ray_tpu_weights_staleness_versions",
                    "latest published version minus the version this "
                    "consumer is serving (0 = fresh)",
                    tag_keys=("name", "consumer")))
    return _metrics
