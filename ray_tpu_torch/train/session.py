"""Train session: the API a `train_fn` sees while it runs under a trainer
(port of ray_tpu/train/session.py; Ray's _TrainSession, report :661,
get_checkpoint :748, get_dataset_shard :1054), with the same
thread-local access: `ray_tpu_torch.train.report(metrics,
checkpoint=...)` from anywhere inside the training function.

report() is the step boundary: it closes the StepTimer's step, publishes
weights into the live weight fabric when asked (`publish_weights=`),
delivers the report, runs the preemption grace flow (a checkpoint
reported after a preemption notice must be on disk before it is
acknowledged) and fires the chaos plan's scripted faults.
"""
from __future__ import annotations

import os
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
    # rendezvous namespace of this gang (unique per fit); consumed by
    # parallel.distributed.setup_torch_distributed
    dist_key: Optional[str] = None
    # the device this rank computes on: "cuda" when its bundle leased a
    # GPU, else "cpu" (the gang's backend follows it: NCCL or gloo)
    device: str = "cuda"
    # multi-slice identity (ScalingConfig.num_slices > 1); slice_map is
    # filled by setup_torch_distributed after the slice rendezvous
    slice_id: Optional[int] = None
    num_slices: int = 1
    slice_map: Optional[Dict[int, Any]] = None
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
    # the active preemption notice (the conductor's `resilience`
    # channel): a host this run touches is going away, checkpoint now
    _preemption: Optional[Dict[str, Any]] = None
    _grace_acked: bool = False
    # resilience.chaos.ChaosMonkey of this attempt (its faults fire at
    # the report() step boundary); None: no chaos
    _chaos: Optional[Any] = None
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
           publish_weights: Any = None,
           weights_name: Optional[str] = None,
           weights_delta: bool = False,
           weights_version: Optional[int] = None) -> None:
    """Report metrics (and optionally a checkpoint) to the trainer.

    report() is the step boundary of the session's StepTimer: it closes
    the current step and merges its record into the metrics under JAX's
    keys (`step_time_ms`, `data_wait_ms`, `bubble_wait_ms`, `compile_ms`,
    `device_step_ms`, `checkpoint_ms`, `report_ms`, `other_ms`,
    `tokens_per_sec`, `mfu`, where known), keeping any value the caller
    gave. The time spent publishing and delivering the report lands in
    the NEXT step's "report" (or "checkpoint") phase. The step is
    `metrics["step"]` when given, else the report count.

    ``publish_weights=params`` publishes this process's shards of the
    tree into the live weight fabric (`weights.publish`) as version
    `step` under ``weights_name`` (default: the experiment name); engines
    synced to that name hot-swap to it between decode ticks. Without a
    ``step`` metric the registry assigns latest + 1 (one process only: a
    gang must report a step so every rank names the same version). A
    restarted attempt replaying an already-published step is a no-op.
    ``weights_delta=True`` ships only the leaves that changed since this
    process's previous publish of the name; ``weights_version``
    overrides the version id."""
    ctx = get_context()
    metrics = dict(metrics)
    ctx._report_count += 1
    step = ctx._report_count
    explicit_step = False
    v = metrics.get("step")
    if v is not None:
        try:
            step = int(v)
            explicit_step = True
        except (TypeError, ValueError):
            step = ctx._report_count
    timer = ctx._step_timer
    timed = timer is not None and timer.enabled
    if timed:
        rec = timer.end_step()
        if rec is not None:
            for key in _TIMER_KEYS:
                if key in rec:
                    metrics.setdefault(
                        "step_time_ms" if key == "total_ms" else key,
                        rec[key])
    if publish_weights is not None:
        from ..weights import publish as _publish

        t0 = time.perf_counter()
        try:
            # the version is the user's step when given (stable across
            # restarts), else registry-assigned latest + 1: the report
            # count restarts at 1 with every attempt
            _publish(publish_weights,
                     name=weights_name or ctx.experiment_name,
                     step=(None if weights_version is not None
                           else step if explicit_step else None),
                     version=weights_version, run_id=ctx.run_id,
                     delta=weights_delta)
        except ValueError as e:
            if "already committed" not in str(e):
                raise
            # a restarted attempt replaying a published step
        if timed:
            timer.record("report", time.perf_counter() - t0)
    if ctx._report_fn is not None:
        if timed:
            t0 = time.perf_counter()
            try:
                ctx._report_fn(metrics, checkpoint)
            finally:
                timer.record(
                    "checkpoint" if checkpoint is not None else "report",
                    time.perf_counter() - t0)
        else:
            ctx._report_fn(metrics, checkpoint)
    if checkpoint is not None and ctx._preemption is not None \
            and not ctx._grace_acked:
        _grace_flow(ctx, checkpoint, step)
    if ctx._chaos is not None:
        # scripted faults fire AFTER the report is delivered, so "kill
        # rank R at step S" leaves step S's report and checkpoint as the
        # resume point
        ctx._chaos.on_step(step)
    if ctx._stop_requested:
        raise StopTrial()


def _grace_flow(ctx: TrainContext, checkpoint: Checkpoint,
                step: int) -> None:
    """A preemption notice asked for a step-fresh checkpoint: an async
    save must be ON DISK (and, in a gang, persisted under the trial's
    `pending/`) before it is acknowledged, within the notice's deadline.
    Every in-flight writer is expedited."""
    committed = True
    if hasattr(checkpoint, "future"):
        from .async_checkpoint import expedite_all

        expedite_all()
        deadline = ctx._preemption.get("deadline")
        budget = (max(1.0, float(deadline) - time.time())
                  if deadline is not None
                  else float(ctx._preemption.get("grace_s") or 30.0))
        try:
            checkpoint.future.result(timeout=budget)
        except Exception:  # noqa: BLE001 — torn or still writing: no
            committed = False  # ack; a later report may land one
        else:
            if ctx.world_size > 1 and ctx.trial_dir:
                # a gang persists async saves into pending/ from a commit
                # hook whose failure is swallowed: a path outside it dies
                # with this host
                pending_root = os.path.abspath(os.path.join(
                    ctx.trial_dir, "pending")) + os.sep
                committed = os.path.abspath(checkpoint.path).startswith(
                    pending_root)
    if committed:
        ctx._grace_acked = True
        _report_resilience_event({
            "kind": "grace_checkpoint", "run_id": ctx.run_id,
            "rank": ctx.rank, "step": step,
            "node_id": ctx._preemption.get("node_id")})


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
    """Inside a train_fn: the active preemption notice, or None.

    When a host this run touches announces a maintenance event or a
    preemption, the conductor broadcasts "checkpoint now, grace N
    seconds" and this returns the notice::

        {"node_id": ..., "grace_s": 30.0, "deadline": <unix ts>,
         "reason": "maintenance"}

    React by reporting a checkpoint promptly: the restarted run resumes
    from it. Outside a session this returns None."""
    ctx = _get_session()
    return ctx._preemption if ctx is not None else None


def _report_resilience_event(event: Dict[str, Any]) -> None:
    """An event for the conductor's resilience log (driver or worker; a
    no-op without a cluster)."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        return
    try:
        w.conductor.notify("report_resilience_event", event)
    except Exception:  # noqa: BLE001 — telemetry only
        pass


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from, if any."""
    return get_context().latest_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's dataset shard."""
    return get_context().dataset_shards.get(name)


class StopTrial(Exception):
    """Raised inside train_fn when the controller stops the trial."""
