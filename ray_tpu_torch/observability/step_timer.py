"""StepTimer: the per-step clock of a training loop (port of the local
part of ray_tpu/observability/step_timer.py).

Partitions each step's wall time into named phases (`data_wait`,
`device_step`, ...) and turns the result into tokens/s and MFU (see
`observability.flops`). `train.step.TrainStep` records `data_wait` (the
batch moved to the card) and `device_step` (the step, synchronised) into
the timer it is given; the loop closes each step with `end_step()`,
whose record is kept in `records` (the newest `KEEP`). A loop that
wants no timing passes no timer; a disabled timer (`enabled=False`, what
`train.session.get_step_timer()` gives outside a session) records
nothing.

Closed records are also buffered and shipped to the conductor in
batches (`report_train_steps`, the JAX package's cadence: every
`_FLUSH_EVERY` records or `_FLUSH_INTERVAL_S`, and at `close()`), where
`observability.gang` builds the gang-wide skew and straggler views
(`util.state.train_progress`) and the merged timeline its step markers.
Without a connected worker nothing is shipped and the buffer keeps the
newest `_PENDING_CAP` records. The JAX package's RAY_TPU_STEP_TELEMETRY
switch is `enabled=`: the port reads no environment.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Deque, Dict, List, Optional

_now = time.perf_counter

PHASES = ("data_wait", "bubble_wait", "compile", "device_step",
          "checkpoint", "report")

_EMA_ALPHA = 0.3  # trailing EMA weight of the newest step
KEEP = 4096       # step records kept

_FLUSH_EVERY = 16          # records per conductor batch
_FLUSH_INTERVAL_S = 2.0    # the JAX package's metric / span cadence
_PENDING_CAP = 4096        # clusterless runs keep only this many records


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an ascending list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize_records(records, ema_alpha: float = _EMA_ALPHA
                      ) -> Dict[str, Any]:
    """Per-phase mean / p50 / p99 / trailing EMA / last over a window of
    step records (`<phase>_ms` keys plus `other_ms` and `total_ms`)."""
    phases: Dict[str, Dict[str, float]] = {}
    for name in (*PHASES, "other", "total"):
        key = f"{name}_ms"
        vals = [float(r[key]) for r in records
                if isinstance(r.get(key), (int, float))]
        if not vals:
            continue
        ordered = sorted(vals)
        ema = vals[0]
        for v in vals[1:]:
            ema = ema_alpha * v + (1.0 - ema_alpha) * ema
        phases[name] = {
            "mean_ms": sum(vals) / len(vals),
            "p50_ms": percentile(ordered, 0.5),
            "p99_ms": percentile(ordered, 0.99),
            "ema_ms": ema,
            "last_ms": vals[-1],
        }
    return {"steps": len(records), "phases": phases}


class _PhaseCM:
    __slots__ = ("_timer", "_name", "_t0")

    def __init__(self, timer: "StepTimer", name: str):
        self._timer = timer
        self._name = name

    def __enter__(self):
        self._timer.ensure_step_open()
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        self._timer.record(self._name, _now() - self._t0)
        return False


_NULL_CM = contextlib.nullcontext()


class StepTimer:
    """Step clock of one training loop: rank `rank` of `world_size` in
    run `run_id` (the conductor's key for its records)."""

    def __init__(self, run_id: str = "", rank: int = 0,
                 world_size: int = 1, enabled: bool = True):
        self.run_id = run_id or "default"
        self.rank = rank
        self.world_size = world_size
        self.enabled = enabled
        self.records: Deque[Dict[str, Any]] = collections.deque(maxlen=KEEP)
        self._step_index = 0
        self._step_start: Optional[float] = None
        self._step_start_wall: Optional[float] = None
        self._acc: Dict[str, float] = {}
        self._pending: List[Dict[str, Any]] = []
        self._last_flush = 0.0
        # MFU inputs, filled in by TrainStep at its first step
        self.tokens_per_step: Optional[int] = None
        self.flops_per_step: Optional[float] = None
        self.peak_flops_total: Optional[float] = None

    def phase(self, name: str):
        """Context manager accumulating wall time into phase `name`."""
        return _PhaseCM(self, name) if self.enabled else _NULL_CM

    def record(self, name: str, seconds: float) -> None:
        """Account `seconds` to phase `name` in the open step. Recording
        into a not-yet-open step backdates the step start by `seconds`."""
        if not self.enabled:
            return
        if self._step_start is None:
            self._begin_step()
            self._step_start -= seconds
            self._step_start_wall -= seconds
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    def ensure_step_open(self) -> None:
        """Start the step clock now if no step is open."""
        if self._step_start is None:
            self._begin_step()

    def _begin_step(self) -> None:
        self._step_start = _now()
        self._step_start_wall = time.time()
        self._acc = {}

    def set_tokens_per_step(self, n: int) -> None:
        self.tokens_per_step = int(n)

    def set_flops_per_step(self, f: Optional[float]) -> None:
        if f:
            self.flops_per_step = float(f)

    def set_peak_flops(self, f: Optional[float]) -> None:
        if f:
            self.peak_flops_total = float(f)

    def end_step(self) -> Optional[Dict[str, Any]]:
        """Close the open step and return its record (None when nothing
        was recorded): `<phase>_ms` for every phase, `other_ms`,
        `total_ms`, and `tokens_per_sec` and `mfu` where their inputs are
        known (MFU against the device-step time)."""
        if not self.enabled or self._step_start is None:
            return None
        now, wall = _now(), time.time()
        total_s = now - self._step_start
        rec: Dict[str, Any] = {"step": self._step_index, "rank": self.rank,
                               "t_start": self._step_start_wall,
                               "t_end": wall, "total_ms": total_s * 1e3}
        accounted = 0.0
        for name in PHASES:
            s = self._acc.get(name, 0.0)
            accounted += s
            rec[f"{name}_ms"] = s * 1e3
        rec["other_ms"] = max(0.0, total_s - accounted) * 1e3
        if self.tokens_per_step:
            rec["tokens"] = self.tokens_per_step
            rec["tokens_per_sec"] = self.tokens_per_step / max(total_s, 1e-9)
        device_s = self._acc.get("device_step", 0.0) or total_s
        # flops imports torch: imported here, a process that imports
        # this module (a serve replica, through serve.autoscale) does
        # not import torch for it
        from . import flops as _flops

        m = _flops.mfu(self.flops_per_step, device_s, self.peak_flops_total)
        if m is not None:
            rec["mfu"] = m
        self._step_index += 1
        self._step_start = None
        self._step_start_wall = None
        self._acc = {}
        self.records.append(rec)
        self._pending.append(rec)
        if len(self._pending) >= _FLUSH_EVERY or \
                now - self._last_flush > _FLUSH_INTERVAL_S:
            self.flush()
        return rec

    def flush(self) -> None:
        """Ship the buffered records to the conductor (best effort:
        without a connected worker they stay buffered, the newest
        `_PENDING_CAP` of them)."""
        if not self._pending:
            return
        self._last_flush = _now()
        batch, self._pending = self._pending, []
        from .._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is None:
            self._pending = batch[-_PENDING_CAP:]
            return
        try:
            w.conductor.notify("report_train_steps", self.run_id,
                               self.rank, batch)
        except Exception:  # noqa: BLE001 — cluster shutting down
            pass

    def close(self) -> None:
        """Teardown: flush the record tail. A step still open is dropped,
        not closed: a teardown-length pseudo-step would skew the gang's
        statistics."""
        self._step_start = None
        self._step_start_wall = None
        self._acc = {}
        self.flush()
