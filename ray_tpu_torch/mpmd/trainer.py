"""PipelineTrainer: the train-API entry point for MPMD pipelines (port
of ray_tpu/mpmd/trainer.py).

The TorchTrainer analog for multi-program execution: where TorchTrainer
runs ONE program, PipelineTrainer runs ``ScalingConfig.num_stages``
separate stage programs on stage-gangs formed by the
:class:`PipelineConductor`, with activations streaming between them over
the chunked object plane. ``num_slices=``, ``device=`` and
``stage_class=`` pass through to the conductor (see there). After
``fit()``, ``stages`` holds each stage's run summary.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..train.config import RunConfig, ScalingConfig
from ..train.trainer import Result
from .conductor import PipelineConductor
from .stage import StageActor


class PipelineTrainer:
    """fit() forms the stage-gangs, drives the schedule, returns a
    train-style :class:`Result` whose metrics history is the last
    stage's per-step loss trajectory."""

    def __init__(self, stage_fns: Sequence[Callable],
                 stage_params: Sequence[Any],
                 loss_fn: Callable,
                 optimizer, *,
                 data_fn: Callable[[int], Any],
                 num_microbatches: int,
                 num_steps: int = 1,
                 schedule: str = "1f1b",
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 recv_timeout: float = 60.0,
                 num_slices: Optional[int] = None,
                 device: Union[str, Sequence[str]] = "cuda",
                 stage_class: type = StageActor):
        self.scaling_config = scaling_config or ScalingConfig(
            num_stages=len(stage_fns))
        if self.scaling_config.num_stages != len(stage_fns):
            raise ValueError(
                f"ScalingConfig.num_stages="
                f"{self.scaling_config.num_stages} but {len(stage_fns)} "
                "stage fns were given")
        if self.scaling_config.num_workers not in (
                1, self.scaling_config.num_stages):
            # one host per stage today; a num_workers that implies
            # multi-host stage-gangs must fail loudly, not silently
            # downgrade to single-process stages
            raise NotImplementedError(
                f"num_workers={self.scaling_config.num_workers} with "
                f"num_stages={self.scaling_config.num_stages}: "
                "stage-gangs run one host per stage today (multi-host "
                "stage-gangs are a ROADMAP follow-up)")
        self.run_config = run_config or RunConfig()
        self.stage_fns = list(stage_fns)
        self.stage_params = list(stage_params)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.data_fn = data_fn
        self.num_microbatches = int(num_microbatches)
        self.num_steps = int(num_steps)
        self.schedule = schedule
        self.recv_timeout = float(recv_timeout)
        self.num_slices = num_slices
        self.device = device
        self.stage_class = stage_class
        self.conductor: Optional[PipelineConductor] = None
        # each stage's run summary from the last fit()
        self.stages: List[Dict[str, Any]] = []

    def fit(self) -> Result:
        import uuid

        # anonymous runs get a unique registry name: a shared constant
        # default would let a second concurrent fit() reopen (and
        # generation-fence-kill) the first run's pipeline
        name = self.run_config.name or f"pipeline/{uuid.uuid4().hex[:8]}"
        pipe = PipelineConductor(
            name, self.stage_fns, self.stage_params, self.optimizer,
            self.loss_fn, num_microbatches=self.num_microbatches,
            schedule=self.schedule,
            resources_per_stage=dict(
                self.scaling_config.resources_per_worker or {}),
            num_slices=self.num_slices, device=self.device,
            stage_class=self.stage_class)
        self.conductor = pipe
        history: List[Dict[str, Any]] = []
        try:
            pipe.form()
            out = pipe.run(self.num_steps, self.data_fn,
                           recv_timeout=self.recv_timeout)
        except Exception as e:  # noqa: BLE001 — surface as train Result
            pipe.close()
            self.conductor = None
            return Result(error=e, metrics={}, metrics_history=[])
        except BaseException:
            # Ctrl-C / SystemExit mid-run: still release the stage
            # actors, placement group and registry entry
            pipe.close()
            self.conductor = None
            raise
        self.stages = out["stages"]
        for step, loss in enumerate(out["losses"]):
            history.append({"loss": loss, "step": step,
                            "_time": time.time()})
        metrics: Dict[str, Any] = dict(history[-1]) if history else {}
        metrics["bubble_fraction"] = [
            s.get("bubble_fraction") for s in out["stages"]]
        pipe.close()
        self.conductor = None
        return Result(metrics=metrics, metrics_history=history)


__all__ = ["PipelineTrainer"]
