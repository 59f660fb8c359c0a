"""Train session: the API a `train_fn` sees while it runs under a trainer
(port of ray_tpu/train/session.py; Ray's _TrainSession, report :661,
get_checkpoint :748, get_dataset_shard :1054), with the same
thread-local access: `ray_tpu_torch.train.report(metrics,
checkpoint=...)` from anywhere inside the training function.

What waits for the port of the actor runtime: publishing weights from
`report` (the weight fabric), the preemption notice and its grace flow
(`preemption_requested` returns None until then), and scripted chaos
faults.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ..observability.step_timer import StepTimer
from .checkpoint import Checkpoint

_local = threading.local()

# the StepTimer record keys report() merges into the metrics, as JAX's
_TIMER_KEYS = ("total_ms", "data_wait_ms", "bubble_wait_ms", "compile_ms",
               "device_step_ms", "checkpoint_ms", "report_ms", "other_ms",
               "tokens_per_sec", "mfu")


@dataclass
class TrainContext:
    world_size: int = 1
    rank: int = 0
    experiment_name: str = "default"
    trial_dir: str = ""
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    latest_checkpoint: Optional[Checkpoint] = None
    # multi-slice identity (ScalingConfig.num_slices > 1)
    slice_id: Optional[int] = None
    num_slices: int = 1
    # identity of this fit
    run_id: str = ""
    # restart generation (0 = first attempt); the trainer's retry loop
    # bumps it
    attempt: int = 0
    # set by the trainer: called with (metrics, checkpoint)
    _report_fn: Optional[Callable[[Dict[str, Any], Optional[Checkpoint]],
                                  None]] = None
    _stop_requested: bool = False
    # the step clock the trainer creates; TrainStep and report() feed it,
    # users reach it through get_step_timer()
    _step_timer: Optional[StepTimer] = None
    _report_count: int = 0

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_slice_id(self) -> int:
        return 0 if self.slice_id is None else self.slice_id


def _set_session(ctx: Optional[TrainContext]) -> None:
    _local.ctx = ctx


def _get_session() -> Optional[TrainContext]:
    return getattr(_local, "ctx", None)


def get_context() -> TrainContext:
    ctx = _get_session()
    if ctx is None:
        raise RuntimeError("No train session active — call inside a "
                           "train_fn run by TorchTrainer")
    return ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None, *,
           publish_weights: Any = None) -> None:
    """Report metrics (and optionally a checkpoint) to the trainer.

    report() is the step boundary of the session's StepTimer: it closes
    the current step and merges its record into the metrics under JAX's
    keys (`step_time_ms`, `data_wait_ms`, `bubble_wait_ms`, `compile_ms`,
    `device_step_ms`, `checkpoint_ms`, `report_ms`, `other_ms`,
    `tokens_per_sec`, `mfu`, where known), keeping any value the caller
    gave. The time spent delivering the report (registering a
    synchronous checkpoint included) lands in the NEXT step's
    "checkpoint" or "report" phase. The step is `metrics["step"]` when
    given, else the report count.

    `publish_weights=` (the live weight fabric) raises
    NotImplementedError: it waits for the port of the actor runtime
    (ROADMAP Queue 1, "the actor runtime")."""
    if publish_weights is not None:
        raise NotImplementedError(
            "report(publish_weights=) needs the weight fabric, which waits "
            "for the port of the actor runtime (ROADMAP Queue 1, "
            "'the actor runtime')")
    ctx = get_context()
    metrics = dict(metrics)
    ctx._report_count += 1
    timer = ctx._step_timer
    if timer is not None and timer.enabled:
        rec = timer.end_step()
        if rec is not None:
            for key in _TIMER_KEYS:
                if key in rec:
                    metrics.setdefault(
                        "step_time_ms" if key == "total_ms" else key,
                        rec[key])
    if ctx._report_fn is not None:
        if timer is not None and timer.enabled:
            t0 = time.perf_counter()
            try:
                ctx._report_fn(metrics, checkpoint)
            finally:
                timer.record(
                    "checkpoint" if checkpoint is not None else "report",
                    time.perf_counter() - t0)
        else:
            ctx._report_fn(metrics, checkpoint)
    if ctx._stop_requested:
        raise StopTrial()


_disabled_timer = StepTimer(enabled=False)


def get_step_timer() -> StepTimer:
    """The active session's StepTimer; use it to attribute data-loading
    or checkpoint time from inside a train_fn:

        with ray_tpu_torch.train.get_step_timer().phase("data_wait"):
            batch = next(batches)

    Always returns a timer: outside a session it is a shared disabled one
    whose phase() is a no-op."""
    ctx = _get_session()
    if ctx is not None and ctx._step_timer is not None:
        return ctx._step_timer
    return _disabled_timer


def preemption_requested() -> Optional[Dict[str, Any]]:
    """The active preemption notice, or None. The notice comes from the
    cluster's conductor, which waits for the port of the actor runtime:
    until then this returns None."""
    return None


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from, if any."""
    return get_context().latest_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's dataset shard."""
    return get_context().dataset_shards.get(name)


class StopTrial(Exception):
    """Raised inside train_fn when the controller stops the trial."""
