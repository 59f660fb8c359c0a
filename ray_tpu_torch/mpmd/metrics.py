"""The MPMD pipeline's Prometheus families (port of ray_tpu/mpmd/
metrics.py), on ``util.metrics`` and created on first use, so importing
``ray_tpu_torch.mpmd`` starts no metrics pusher. Each stage also puts
their values into the stats it reports to the conductor
(``metrics_snapshot``), so ``util.state.pipeline_status()`` carries
them:

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

_metrics: Optional[Dict[str, Any]] = None
_lock = threading.Lock()


def pipeline_metrics() -> Dict[str, Any]:
    global _metrics
    m = _metrics
    if m is not None:
        return m
    with _lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge

            _metrics = dict(
                bubble_fraction=Gauge(
                    "ray_tpu_pipeline_bubble_fraction",
                    "per-stage pipeline bubble: bubble_wait over step "
                    "wall time for the most recent step",
                    tag_keys=("pipeline", "stage")),
                activations_bytes=Counter(
                    "ray_tpu_pipeline_activations_bytes_total",
                    "microbatch activation/gradient bytes through the "
                    "MPMD channels (chunked object-plane transfer)",
                    tag_keys=("pipeline", "stage", "direction")))
    return _metrics


def metrics_snapshot() -> Dict[str, Dict[str, float]]:
    """{family name: {"k=v,...": value}} of this process's pipeline
    series."""
    return {m.name: {",".join(f"{k}={v}"
                              for k, v in zip(m._tag_keys, key)): val
                     for key, val in m.series().items()}
            for m in pipeline_metrics().values()}
