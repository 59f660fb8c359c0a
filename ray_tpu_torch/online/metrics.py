"""The online learning loop's Prometheus families (port of
ray_tpu/online/metrics.py), on ``util.metrics`` and created on first
use, so importing ``ray_tpu_torch.online`` starts no metrics pusher:

- ray_tpu_online_rollout_tokens_total{sampler}   tokens generated into
                                                 rollouts, per sampler
- ray_tpu_online_rollouts_total{sampler}         completed rollouts
- ray_tpu_online_buffer_occupancy{buffer}        rollouts queued now
- ray_tpu_online_buffer_rejected_total{buffer}   backpressured puts
- ray_tpu_online_ingested_rollouts_total{run}    rollouts the learner
                                                 consumed

Sampler staleness has no twin here: it is the weight fabric's
``ray_tpu_weights_staleness_versions`` gauge, which each sampler's
WeightSync sets.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_metrics: Optional[Dict[str, Any]] = None
_lock = threading.Lock()


def online_metrics() -> Dict[str, Any]:
    global _metrics
    m = _metrics
    if m is not None:
        return m
    with _lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge

            _metrics = dict(
                rollout_tokens=Counter(
                    "ray_tpu_online_rollout_tokens_total",
                    "tokens generated into rollouts by online-loop "
                    "samplers",
                    tag_keys=("sampler",)),
                rollouts=Counter(
                    "ray_tpu_online_rollouts_total",
                    "rollouts completed by online-loop samplers",
                    tag_keys=("sampler",)),
                buffer_occupancy=Gauge(
                    "ray_tpu_online_buffer_occupancy",
                    "rollouts currently queued in the online-loop "
                    "buffer",
                    tag_keys=("buffer",)),
                buffer_rejected=Counter(
                    "ray_tpu_online_buffer_rejected_total",
                    "rollout puts rejected by a full buffer "
                    "(sampler backpressure)",
                    tag_keys=("buffer",)),
                ingested_rollouts=Counter(
                    "ray_tpu_online_ingested_rollouts_total",
                    "rollouts the online learner pulled into training "
                    "batches",
                    tag_keys=("run",)))
    return _metrics
