"""Restart backoff (port of ray_tpu/resilience/supervisor.py:22-37).

The JAX package reads its defaults from RAY_TPU_RESTART_BACKOFF_BASE_S /
_MAX_S; the port reads no environment variable: the defaults below are
that flag table's (1.0 s, 30.0 s), and `train.trainer.TorchTrainer`
takes them as constructor arguments.
"""
from __future__ import annotations

import random

RESTART_BACKOFF_BASE_S = 1.0
RESTART_BACKOFF_MAX_S = 30.0


def backoff_delay(attempt: int, base_s: float = RESTART_BACKOFF_BASE_S,
                  cap_s: float = RESTART_BACKOFF_MAX_S,
                  jitter_frac: float = 0.25, rand=random.random) -> float:
    """Exponential backoff with jitter for restart attempt `attempt`
    (1-based): min(cap, base * 2**(attempt-1)) * (1 + jitter*U[0,1))."""
    attempt = max(1, int(attempt))
    delay = min(float(cap_s), float(base_s) * (2.0 ** (attempt - 1)))
    return delay * (1.0 + max(0.0, jitter_frac) * rand())
