"""The MPMD pipeline's in-process metrics (port of ray_tpu/mpmd/
metrics.py: the same families, kept in this process as
`serve.handle.Counter` / `Gauge` until `util/metrics.py` is ported).
Each stage puts their snapshot into the stats it reports to the
conductor, so `util.state.pipeline_status()` carries them:

- ray_tpu_pipeline_bubble_fraction{pipeline,stage}   per-stage idle
                                   fraction of the last pipeline step
                                   (bubble_wait over step wall time)
- ray_tpu_pipeline_activations_bytes_total{pipeline,stage,direction}
                                   microbatch tensor bytes moved through
                                   the activation / gradient channels
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..serve.handle import Counter, Gauge

_metrics: Optional[Dict[str, Any]] = None
_lock = threading.Lock()


def pipeline_metrics() -> Dict[str, Any]:
    global _metrics
    with _lock:
        if _metrics is None:
            _metrics = dict(
                bubble_fraction=Gauge(
                    "ray_tpu_pipeline_bubble_fraction",
                    "per-stage pipeline bubble: bubble_wait over step "
                    "wall time for the most recent step",
                    ("pipeline", "stage")),
                activations_bytes=Counter(
                    "ray_tpu_pipeline_activations_bytes_total",
                    "microbatch activation/gradient bytes through the "
                    "MPMD channels (chunked object-plane transfer)",
                    ("pipeline", "stage", "direction")))
        return _metrics


def metrics_snapshot() -> Dict[str, Dict[str, float]]:
    """{family name: {"k=v,...": value}} of this process's pipeline
    metrics."""
    return {m.name: m.snapshot() for m in pipeline_metrics().values()}
