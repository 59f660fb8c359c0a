"""TorchTrainer: the port's counterpart of the JAX package's `JaxTrainer`
(ray_tpu/train/trainer.py; Ray's TorchTrainer -> DataParallelTrainer ->
BackendExecutor -> WorkerGroup).

- ``mode="spmd"`` (the default): `fit()` runs `train_fn(config)` in this
  process under a train session (`session.report`, `get_checkpoint`,
  `get_dataset_shard`).
- ``mode="workers"`` with ``num_workers > 1``: a gang of actor ranks,
  placed together by a STRICT_PACK placement group, each running
  `train_fn` with its rank and world size. Each rank's bundle is
  `resources_per_worker` (default one CPU), plus one GPU when
  `ScalingConfig.use_gpu` (the default) and it names none, as in Ray's
  ScalingConfig. Before train_fn each rank joins one torch.distributed
  process group (`parallel.distributed.setup_torch_distributed`): NCCL
  on its leased CUDA device when its bundle holds a GPU, gloo on the CPU
  when it does not (`use_gpu=False`). A `GangSupervisor` kills the survivors the moment one rank dies
  (a survivor blocked in a collective never sees a cancel), so the fit
  fails fast and restarts. Each rank's reports come back to the driver
  and are aggregated per step (`rank_metrics`); a rank's checkpoint is
  moved into `{storage}/pending` when it is reported (an async one when
  it commits), so a gang that dies leaves it behind.

Both modes keep the reported checkpoints under `{storage}/checkpoints`
(top K by `CheckpointConfig`) and, on a failure, restart `train_fn` from
the newest checkpoint (registered, else the newest under `pending/`)
after an exponential backoff, up to `FailureConfig.max_failures` times
(-1: unbounded); once the budget is spent `fit()` returns
`Result(error=...)`. Before a workers-mode restart, a gang that no
longer fits the schedulable capacity re-forms smaller when
`ScalingConfig.min_workers` allows (`resilience.elastic_reform`). A
session subscribes to the conductor's preemption notices
(`preemption_requested()`), and `chaos_plan=` (a
`resilience.chaos.ChaosPlan` or its spec) scripts faults into every
rank's report(). KeyboardInterrupt and SystemExit are re-raised, not
retried. Restarts, recoveries (with the time to recovery) and elastic
re-forms go to the conductor's resilience log.

Where the JAX package reads RAY_TPU_CHAOS_PLAN and
RAY_TPU_RESTART_BACKOFF_*, the port takes `chaos_plan=`,
`restart_backoff_base_s=` and `restart_backoff_max_s=`.
"""
from __future__ import annotations

import logging
import os
import shutil
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..observability.step_timer import StepTimer
from ..resilience.chaos import ChaosPlan, as_plan, monkey_from_spec
from ..resilience.supervisor import (RESTART_BACKOFF_BASE_S,
                                     RESTART_BACKOFF_MAX_S, backoff_delay,
                                     elastic_reform)
from .async_checkpoint import AsyncCheckpoint
from .checkpoint import Checkpoint, CheckpointManager
from .config import (RunConfig, ScalingConfig, ShardingConfig,
                     assign_worker_slices)
from .session import (StopTrial, TrainContext, _report_resilience_event,
                      _set_session)
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


def _subscribe_preemption(ctx: TrainContext):
    """Route the conductor's `resilience` pubsub into the session, so
    `train.preemption_requested()` sees the notice; in-flight async
    saves are expedited at once. Returns an unsubscribe token (None
    without a cluster)."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        return None

    def on_msg(msg, _ctx=ctx):
        if isinstance(msg, dict) and msg.get("kind") == "preemption":
            _ctx._preemption = msg
            from .async_checkpoint import expedite_all

            expedite_all()

    w.subscribe_channel("resilience", on_msg)
    return (w, on_msg)


def _unsubscribe_preemption(token) -> None:
    if token is None:
        return
    try:
        token[0].unsubscribe_channel("resilience", token[1])
    except Exception:  # noqa: BLE001 — worker already torn down
        pass


def _persist_checkpoint(ck: Checkpoint, trial_dir: str, rank: int,
                        seq: int, attempt: int = 0) -> Checkpoint:
    """Move a reported checkpoint into `{trial_dir}/pending` NOW, on the
    rank, at report time: a gang that dies mid-training must leave its
    checkpoints on shared storage for the restart. Names sort
    attempt-major (`{attempt:04d}-{seq:06d}-rank{rank}`): `seq`, the
    report count, restarts at 0 with every attempt, and a long first
    attempt must not out-sort a short second one."""
    pending = os.path.join(trial_dir, "pending")
    os.makedirs(pending, exist_ok=True)
    dst = os.path.join(pending, f"{attempt:04d}-{seq:06d}-rank{rank}")
    if os.path.abspath(ck.path) == dst:
        return ck
    if os.path.exists(dst):
        shutil.rmtree(dst)
    try:
        os.replace(ck.path, dst)
    except OSError:  # another filesystem
        shutil.copytree(ck.path, dst)
        shutil.rmtree(ck.path, ignore_errors=True)
    ck.path = dst
    return ck


def _worker_bundle(sc: ScalingConfig) -> Dict[str, float]:
    """One rank's resources: `resources_per_worker` (default one CPU),
    plus one GPU when `use_gpu` and it names none (Ray's ScalingConfig
    does the same). A GPU named while `use_gpu` is False is refused."""
    bundle = dict(sc.resources_per_worker or {"CPU": 1.0})
    bundle.setdefault("CPU", 1.0)
    if sc.use_gpu:
        bundle.setdefault("GPU", 1.0)
    elif bundle.get("GPU", 0):
        raise ValueError(
            "ScalingConfig: use_gpu is False but resources_per_worker "
            f"asks for {bundle['GPU']} GPU")
    return bundle


def _newest_pending_checkpoint(storage: str) -> Optional[Checkpoint]:
    """Latest rank-persisted checkpoint under `{storage}/pending` (names
    sort as {attempt:04d}-{seq:06d}-rank{r}, newest last)."""
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


class _TrainWorker:
    """One rank of the gang (Ray's WorkerGroup worker,
    _internal/worker_group.py:102), run as an actor."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def run(self, fn_bytes: bytes, cfg: Dict[str, Any], trial_dir: str,
            shards: Dict[str, Any], latest_path: Optional[str],
            dist_key: Optional[str], device: str,
            slice_id: Optional[int], num_slices: int, run_id: str,
            attempt: int, chaos_plan: Any
            ) -> List[Any]:
        from .._private import serialization

        fn = serialization.loads(fn_bytes)
        out: List[Any] = []

        def report_fn(metrics, checkpoint):
            if checkpoint is not None:
                # durable at report time (an async save at its commit,
                # strictly before its wait() returns): a gang killed
                # mid-training leaves its checkpoints behind
                if isinstance(checkpoint, AsyncCheckpoint):
                    seq = len(out)
                    checkpoint.add_commit_hook(
                        lambda c, _seq=seq: _persist_checkpoint(
                            c, trial_dir, self.rank, _seq, attempt))
                else:
                    checkpoint = _persist_checkpoint(
                        checkpoint, trial_dir, self.rank, len(out),
                        attempt)
            out.append((metrics, checkpoint))

        # each rank records its own steps; the conductor aggregates the
        # gang's view (straggler detection, the merged timeline)
        timer = StepTimer(run_id, rank=self.rank, world_size=self.world)
        ctx = TrainContext(
            world_size=self.world, rank=self.rank, trial_dir=trial_dir,
            dataset_shards=shards,
            latest_checkpoint=Checkpoint(latest_path) if latest_path
            else None,
            dist_key=dist_key, device=device, slice_id=slice_id,
            num_slices=num_slices, run_id=run_id, attempt=attempt,
            _report_fn=report_fn, _step_timer=timer,
            _chaos=monkey_from_spec(chaos_plan, rank=self.rank,
                                    attempt=attempt))
        preempt_sub = _subscribe_preemption(ctx)
        _set_session(ctx)
        formed = False
        try:
            if dist_key is not None and self.world > 1:
                # the gang's process group, formed FOR train_fn (Ray's
                # backend does it, train/torch/config.py:64-117)
                from ..parallel.distributed import setup_torch_distributed

                setup_torch_distributed()
                formed = True
            fn(cfg)
        except StopTrial:
            pass
        finally:
            _set_session(None)
            _unsubscribe_preemption(preempt_sub)
            timer.close()  # ship this rank's tail of step records
            if formed:
                import torch.distributed as dist

                if dist.is_initialized():
                    dist.destroy_process_group()
        # In-flight async saves must be on disk before run() returns (the
        # driver kills this worker next); a save that failed, or whose
        # move into pending/ failed, comes back as path None.
        pending_root = os.path.abspath(
            os.path.join(trial_dir, "pending")) + os.sep
        resolved: List[Any] = []
        for metrics, ck in out:
            path = None
            if ck is not None:
                ok = True
                if isinstance(ck, AsyncCheckpoint):
                    try:
                        ck.wait()
                    except Exception:  # noqa: BLE001 — torn
                        ok = False
                    else:
                        ok = os.path.abspath(ck.path).startswith(
                            pending_root)
                path = ck.path if ok else None
            resolved.append((metrics, path))
        return resolved


class TorchTrainer:
    """fit() runs train_fn under a session (Ray's BaseTrainer.fit). The
    signature is JaxTrainer's, plus the chaos plan and the restart
    backoff's base and cap (seconds), which the JAX package reads from
    the environment."""

    def __init__(self, train_fn: Callable[[Dict[str, Any]], None], *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 sharding_config: Optional[ShardingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 mode: str = "spmd",
                 chaos_plan: Any = None,
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
        self.chaos_plan: ChaosPlan = as_plan(chaos_plan)
        self.restart_backoff_base_s = restart_backoff_base_s
        self.restart_backoff_max_s = restart_backoff_max_s

    def _gang(self) -> bool:
        return self.mode == "workers" and self.scaling_config.num_workers > 1

    def fit(self) -> Result:
        if self._gang():
            from .._private import worker as worker_mod

            if worker_mod.global_worker is None:
                raise RuntimeError(
                    "mode='workers' runs a gang of actor ranks: call "
                    "ray_tpu_torch.init() first")
        storage = self.run_config.resolved_storage_path()
        os.makedirs(storage, exist_ok=True)
        cc = self.run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(storage, "checkpoints"),
            num_to_keep=cc.num_to_keep,
            score_attribute=cc.checkpoint_score_attribute,
            score_order=cc.checkpoint_score_order)
        max_failures = self.run_config.failure_config.max_failures
        name = self.run_config.name or "default"
        attempt = 0
        latest = self.resume_from_checkpoint
        first_failure_ts: Optional[float] = None
        while True:
            try:
                if self._gang():
                    result = self._fit_workers(manager, latest, storage,
                                               attempt)
                else:
                    result = self._fit_spmd(manager, latest, storage,
                                            attempt)
                result.path = storage
                if attempt and first_failure_ts is not None:
                    # time to recovery: first failure -> successful fit
                    _report_resilience_event({
                        "kind": "recovery", "name": name,
                        "attempts": attempt,
                        "ttr_s": round(time.time() - first_failure_ts, 3)})
                return result
            except (KeyboardInterrupt, SystemExit):
                # deliberate stops are not failures
                raise
            except Exception as e:  # noqa: BLE001
                attempt += 1
                if first_failure_ts is None:
                    first_failure_ts = time.time()
                # checkpoint-restart: the newest registered checkpoint, or
                # what a dead gang left in pending/
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
                _report_resilience_event({
                    "kind": "restart", "name": name, "attempt": attempt,
                    "cause": f"{type(e).__name__}: {e}"[:500],
                    "backoff_s": round(delay, 3),
                    "resume_from": latest.path if latest else None})
                time.sleep(delay)
                self._maybe_elastic_reform()

    def _maybe_elastic_reform(self) -> None:
        """Before a workers-mode restart: if the schedulable capacity
        shrank below the gang (a dead host quarantined, a host draining)
        and ScalingConfig.min_workers is set, re-form smaller."""
        if self.mode != "workers" or \
                self.scaling_config.min_workers is None:
            return
        from .._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is None:
            return
        try:
            avail = w.conductor.call("schedulable_resources", timeout=10.0)
        except Exception:  # noqa: BLE001 — conductor mid-restart
            return
        per_worker = _worker_bundle(self.scaling_config)
        cap = min((int(avail.get(k, 0.0) // v)
                   for k, v in per_worker.items() if v > 0), default=0)
        reformed = elastic_reform(self.scaling_config,
                                  self.sharding_config, cap)
        if reformed is None:
            return
        old_n = self.scaling_config.num_workers
        old_slices = self.scaling_config.num_slices
        self.scaling_config, self.sharding_config = reformed
        logger.warning(
            "elastic re-form: capacity shrank to %d worker slot(s); gang "
            "%d workers/%d slices -> %d workers/%d slices", cap, old_n,
            old_slices, self.scaling_config.num_workers,
            self.scaling_config.num_slices)
        _report_resilience_event({
            "kind": "elastic_reform",
            "name": self.run_config.name or "default",
            "from_workers": old_n,
            "to_workers": self.scaling_config.num_workers,
            "from_slices": old_slices,
            "to_slices": self.scaling_config.num_slices})

    # ----------------------------------------------------------- spmd mode

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
        run_id = f"{name}/{uuid.uuid4().hex[:8]}"
        timer = StepTimer(run_id, rank=0, world_size=1)
        ctx = TrainContext(
            world_size=1, rank=0, experiment_name=name, trial_dir=storage,
            dataset_shards=self._shard_datasets(0, 1),
            latest_checkpoint=latest,
            run_id=run_id, attempt=attempt,
            _report_fn=report_fn, _step_timer=timer,
            _chaos=monkey_from_spec(self.chaos_plan, rank=0,
                                    attempt=attempt))
        cfg = dict(self.train_loop_config)
        cfg["sharding_config"] = self.sharding_config
        preempt_sub = _subscribe_preemption(ctx)
        _set_session(ctx)
        try:
            self.train_fn(cfg)
        except StopTrial:
            pass
        finally:
            _set_session(None)
            _unsubscribe_preemption(preempt_sub)
            timer.close()  # flush the tail of the step-record batch
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

    # --------------------------------------------------------- worker mode

    def _fit_workers(self, manager: CheckpointManager,
                     latest: Optional[Checkpoint], storage: str,
                     attempt: int = 0) -> Result:
        import ray_tpu_torch as rt

        from .._private import serialization
        from ..resilience.supervisor import GangSupervisor
        from ..util.placement_group import (placement_group,
                                            remove_placement_group)

        n = self.scaling_config.num_workers
        bundle = _worker_bundle(self.scaling_config)
        pg = placement_group([dict(bundle) for _ in range(n)],
                             strategy="STRICT_PACK")
        rpw = dict(bundle)
        # a rank's device follows its lease: a bundle with a GPU gives a
        # CUDA rank (NCCL), one without a CPU rank (gloo)
        gpus = rpw.pop("GPU", 0)
        device = "cuda" if gpus else "cpu"
        # lease the bundle's resources (not the 0-CPU actor default): the
        # gang occupies its reserved capacity, and each rank's lease is
        # charged to the host its bundle lives on
        opts: Dict[str, Any] = {"placement_group": pg,
                                "num_cpus": rpw.pop("CPU")}
        if gpus:
            opts["num_gpus"] = gpus
        if rpw:
            opts["resources"] = rpw
        fn_bytes = serialization.dumps(self.train_fn)
        cfg = dict(self.train_loop_config)
        cfg["sharding_config"] = self.sharding_config
        dist_key = None
        if getattr(self.scaling_config, "setup_torch_distributed", True):
            dist_key = f"train-gang/{uuid.uuid4().hex}"
        num_slices = max(1, self.scaling_config.num_slices)
        slice_ids = assign_worker_slices(n, num_slices)
        run_id = f"{self.run_config.name or 'default'}/{uuid.uuid4().hex[:8]}"
        Worker = rt.remote(_TrainWorker).options(**opts)
        workers: List[Any] = []
        try:
            if not pg.wait():
                # no host has room for the gang (a GPU bundle on a
                # cluster without GPUs: pass use_gpu=False for CPU ranks)
                raise RuntimeError(
                    f"the gang's {n} bundles of {bundle} found no room "
                    f"on one host; the cluster has "
                    f"{rt.available_resources()}")
            # created at once: each rank's process loads this module (and
            # torch) before its actor is placed
            with ThreadPoolExecutor(n) as pool:
                futures = [pool.submit(Worker.remote, rank=i, world=n)
                           for i in range(n)]
            errors = [f.exception() for f in futures]
            workers = [f.result() for f, e in zip(futures, errors)
                       if e is None]
            if any(errors):
                raise next(e for e in errors if e is not None)
            refs = [w.run.remote(
                fn_bytes, cfg, storage, self._shard_datasets(i, n),
                latest.path if latest else None, dist_key, device,
                slice_ids[i], num_slices, run_id, attempt,
                self.chaos_plan)
                for i, w in enumerate(workers)]
            # one dead rank -> the survivors are killed (their collectives
            # can never complete), so this get fails fast and the retry
            # loop restarts from a checkpoint
            with GangSupervisor(workers, run_id=run_id):
                all_reports = rt.get(refs)
        finally:
            for w in workers:
                try:
                    rt.kill(w)
                except Exception:  # noqa: BLE001 — already dead
                    pass
            remove_placement_group(pg)
        # every rank's reports per step: the lowest reporting rank's
        # metrics are the headline, "rank_metrics" has one entry per rank
        # that reported that step, and the first rank's checkpoint path
        # registers
        history, last_metrics = [], {}
        n_steps = max((len(r) for r in all_reports), default=0)
        for i in range(n_steps):
            per_rank = [(rank, r[i]) for rank, r in enumerate(all_reports)
                        if len(r) > i]
            metrics = dict(per_rank[0][1][0] or {})
            metrics["rank_metrics"] = [m for _, (m, _p) in per_rank]
            history.append(metrics)
            last_metrics = metrics
            ckpt_path = next((p for _, (_m, p) in per_rank if p), None)
            if ckpt_path:
                manager.register(Checkpoint(ckpt_path), metrics)
        return Result(metrics=last_metrics,
                      checkpoint=manager.best_checkpoint
                      or manager.latest_checkpoint or latest,
                      metrics_history=history)

    # ------------------------------------------------------------ datasets

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
