"""The online learning loop's in-process counters (port of
ray_tpu/online/metrics.py: the same families, kept in this process as
`serve.handle.Counter` / `Gauge` until `util/metrics.py` is ported):

- ray_tpu_online_rollout_tokens_total{sampler}   tokens generated into
                                                 rollouts, per sampler
- ray_tpu_online_rollouts_total{sampler}         completed rollouts
- ray_tpu_online_buffer_occupancy{buffer}        rollouts queued now
- ray_tpu_online_buffer_rejected_total{buffer}   backpressured puts
- ray_tpu_online_ingested_rollouts_total{run}    rollouts the learner
                                                 consumed

Sampler staleness has no twin here: it is the weight fabric's
staleness, each sampler's WeightSync samples it.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..serve.handle import Counter, Gauge

_metrics: Optional[Dict[str, Any]] = None
_lock = threading.Lock()


def online_metrics() -> Dict[str, Any]:
    global _metrics
    with _lock:
        if _metrics is None:
            _metrics = dict(
                rollout_tokens=Counter(
                    "ray_tpu_online_rollout_tokens_total",
                    "tokens generated into rollouts by online-loop "
                    "samplers", ("sampler",)),
                rollouts=Counter(
                    "ray_tpu_online_rollouts_total",
                    "rollouts completed by online-loop samplers",
                    ("sampler",)),
                buffer_occupancy=Gauge(
                    "ray_tpu_online_buffer_occupancy",
                    "rollouts queued in the online-loop buffer",
                    ("buffer",)),
                buffer_rejected=Counter(
                    "ray_tpu_online_buffer_rejected_total",
                    "rollout puts rejected by a full buffer",
                    ("buffer",)),
                ingested_rollouts=Counter(
                    "ray_tpu_online_ingested_rollouts_total",
                    "rollouts the online learner pulled into batches",
                    ("run",)))
        return _metrics
