"""The serving SLO and the trailing-window signal the disaggregated
router reports (part of the port of ray_tpu/serve/autoscale.py).

`SlidingWindow` keeps scalar samples of the last `window_s` seconds and
summarizes them (n, mean, p50, p99, last): a router's recent TTFT,
queue depth, prefill in-flight and cache hit rate read RECENT values,
not lifetime totals. `TARGET_P99_MS` is the serving SLO (p99 TTFT) a
tenant's slow first token is counted against. The JAX package's knobs
``RAY_TPU_AUTOSCALE_WINDOW_S`` (30) and
``RAY_TPU_AUTOSCALE_TARGET_P99_MS`` (1500) are these defaults.

Not ported with it: `DisaggAutoscaler`, `DisaggPolicy`, `TierSpec` and
the scaling policy engine (the self-healer, the SLO scaling and the
speculation discount; ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..observability.step_timer import percentile

# the serving SLO the loop closes on: recent p99 TTFT, ms
TARGET_P99_MS = 1500.0
WINDOW_S = 30.0


class SlidingWindow:
    """Trailing-window scalar samples -> recent summary. Samples older
    than ``window_s`` age out; ``max_samples`` bounds memory."""

    def __init__(self, window_s: float = WINDOW_S, max_samples: int = 2048):
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: List[Tuple[float, float]] = []  # (ts, value)

    def add(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, float(value)))
            if len(self._samples) > self.max_samples:
                del self._samples[:len(self._samples) - self.max_samples]

    def _values(self, now: Optional[float]) -> List[float]:
        now = time.monotonic() if now is None else now
        horizon = now - self.window_s
        with self._lock:
            i = 0
            while i < len(self._samples) and self._samples[i][0] < horizon:
                i += 1
            if i:
                del self._samples[:i]
            return [v for _, v in self._samples]

    def summary(self, now: Optional[float] = None) -> Dict[str, Any]:
        """{"n", "mean", "p50", "p99", "last"} over the live window
        ({"n": 0} when empty: no evidence, never zero)."""
        vals = self._values(now)
        if not vals:
            return {"n": 0}
        ordered = sorted(vals)
        return {"n": len(vals), "mean": sum(vals) / len(vals),
                "p50": percentile(ordered, 0.5),
                "p99": percentile(ordered, 0.99), "last": vals[-1]}


__all__ = ["SlidingWindow", "TARGET_P99_MS", "WINDOW_S"]
