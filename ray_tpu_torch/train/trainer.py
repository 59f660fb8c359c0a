"""TorchTrainer: the port's counterpart of the JAX package's `JaxTrainer`
(ray_tpu/train/trainer.py), its `spmd` mode.

`fit()` runs `train_fn(config)` in this process under a train session
(`session.report`, `get_checkpoint`, `get_dataset_shard`), keeps the
reported checkpoints under `{storage}/checkpoints` (top K by
`CheckpointConfig`), and on a failure restarts `train_fn` from the newest
registered checkpoint after an exponential backoff, up to
`FailureConfig.max_failures` times (-1: unbounded); once the budget is
spent it returns `Result(error=...)`. KeyboardInterrupt and SystemExit
are re-raised, not retried. An async checkpoint (`async_save`) reserves
its place at report time and registers from its commit hook, so
report() does not wait for the disk; every pending save is drained
before the attempt's result.

`mode="workers"` with `num_workers > 1` (a gang of actor processes)
waits for the port of the actor runtime and raises NotImplementedError.
"""
from __future__ import annotations

import logging
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..observability.step_timer import StepTimer
from ..resilience.supervisor import (RESTART_BACKOFF_BASE_S,
                                     RESTART_BACKOFF_MAX_S, backoff_delay)
from .async_checkpoint import AsyncCheckpoint
from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig, ScalingConfig, ShardingConfig
from .session import StopTrial, TrainContext, _set_session
from .step import TrainStep  # noqa: F401 — part of the train surface

logger = logging.getLogger(__name__)


@dataclass
class Result:
    """Ray's air/result.py Result."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: str = ""
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    # the trial's hyperparameter config (empty for plain Trainer fits)
    config: Dict[str, Any] = field(default_factory=dict)


def _newest_pending_checkpoint(storage: str) -> Optional[Checkpoint]:
    """Latest worker-persisted checkpoint under `{storage}/pending` (names
    sort as {attempt:04d}-{seq:06d}-rank{r}, newest last). Only the
    workers mode, with the actor runtime, writes there."""
    pending = os.path.join(storage, "pending")
    try:
        names = sorted(os.listdir(pending))
    except OSError:
        return None
    for name in reversed(names):
        path = os.path.join(pending, name)
        if os.path.isdir(path):
            return Checkpoint(path)
    return None


class TorchTrainer:
    """fit() runs train_fn under a session (Ray's BaseTrainer.fit). The
    signature is JaxTrainer's, plus the restart backoff's base and cap
    (seconds), which the JAX package reads from the environment."""

    def __init__(self, train_fn: Callable[[Dict[str, Any]], None], *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 sharding_config: Optional[ShardingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 mode: str = "spmd",
                 restart_backoff_base_s: float = RESTART_BACKOFF_BASE_S,
                 restart_backoff_max_s: float = RESTART_BACKOFF_MAX_S):
        self.train_fn = train_fn
        self.train_loop_config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.sharding_config = sharding_config or ShardingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = dict(datasets or {})
        self.resume_from_checkpoint = resume_from_checkpoint
        self.mode = mode
        self.restart_backoff_base_s = restart_backoff_base_s
        self.restart_backoff_max_s = restart_backoff_max_s

    def fit(self) -> Result:
        if self.mode == "workers" and self.scaling_config.num_workers > 1:
            raise NotImplementedError(
                "mode='workers' with num_workers > 1 runs a gang of actor "
                "processes, which waits for the port of the actor runtime "
                "(ROADMAP Queue 1, 'the actor runtime')")
        storage = self.run_config.resolved_storage_path()
        os.makedirs(storage, exist_ok=True)
        cc = self.run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(storage, "checkpoints"),
            num_to_keep=cc.num_to_keep,
            score_attribute=cc.checkpoint_score_attribute,
            score_order=cc.checkpoint_score_order)
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        latest = self.resume_from_checkpoint
        while True:
            try:
                result = self._fit_spmd(manager, latest, storage, attempt)
                result.path = storage
                return result
            except (KeyboardInterrupt, SystemExit):
                # deliberate stops are not failures
                raise
            except Exception as e:  # noqa: BLE001
                attempt += 1
                # checkpoint-restart: the newest registered checkpoint
                latest = (manager.latest_checkpoint
                          or _newest_pending_checkpoint(storage) or latest)
                if max_failures >= 0 and attempt > max_failures:
                    return Result(error=e, checkpoint=latest, path=storage,
                                  metrics={})
                delay = backoff_delay(attempt, self.restart_backoff_base_s,
                                      self.restart_backoff_max_s)
                logger.warning(
                    "train attempt %d failed with %s: %s — restarting "
                    "from %s in %.2fs", attempt, type(e).__name__, e,
                    latest.path if latest else "scratch", delay)
                time.sleep(delay)

    def _fit_spmd(self, manager: CheckpointManager,
                  latest: Optional[Checkpoint], storage: str,
                  attempt: int = 0) -> Result:
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        pending_ckpts: List[AsyncCheckpoint] = []

        def report_fn(metrics: Dict[str, Any],
                      checkpoint: Optional[Checkpoint]) -> None:
            nonlocal last_metrics
            metrics = dict(metrics)
            metrics.setdefault("_time", time.time())
            history.append(metrics)
            last_metrics = metrics
            if checkpoint is None:
                return
            if isinstance(checkpoint, AsyncCheckpoint):
                # in flight: reserve the recency slot now, register at
                # commit on the writer thread
                snap = dict(metrics)
                idx = manager.reserve_index()
                checkpoint.add_commit_hook(
                    lambda c: manager.register(c, snap, index=idx))
                pending_ckpts.append(checkpoint)
            else:
                manager.register(checkpoint, metrics)

        name = self.run_config.name or "default"
        ctx = TrainContext(
            world_size=1, rank=0, experiment_name=name, trial_dir=storage,
            dataset_shards=self._shard_datasets(0, 1),
            latest_checkpoint=latest,
            run_id=f"{name}/{uuid.uuid4().hex[:8]}", attempt=attempt,
            _report_fn=report_fn, _step_timer=StepTimer())
        cfg = dict(self.train_loop_config)
        cfg["sharding_config"] = self.sharding_config
        _set_session(ctx)
        try:
            self.train_fn(cfg)
        except StopTrial:
            pass
        finally:
            _set_session(None)
            # drain in-flight async saves before the result: best/latest
            # must reflect every reported checkpoint
            for c in pending_ckpts:
                try:
                    c.wait()
                except Exception:  # noqa: BLE001 — failed save ≠ failed fit
                    logger.exception("async checkpoint %s failed", c.path)
        return Result(metrics=last_metrics,
                      checkpoint=manager.best_checkpoint
                      or manager.latest_checkpoint or latest,
                      metrics_history=history)

    def _shard_datasets(self, rank: int, world: int) -> Dict[str, Any]:
        shards: Dict[str, Any] = {}
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                shards[name] = ds.streaming_split(world)[rank]
            elif world > 1 and hasattr(ds, "__getitem__"):
                shards[name] = ds[rank::world]
            else:
                shards[name] = ds
        return shards
