"""PipelineConductor: forms the stage-gangs and supervises the run (port
of ray_tpu/mpmd/conductor.py).

One stage per slice: each stage of the pipeline is its own gang (one
actor process per stage; ``hosts_per_stage != 1`` is refused loudly, as
in the JAX package) assigned a slice identity, so a stage shares a
failure domain with nothing but itself. ``pipeline_register_stage``
commits the pipeline "formed" atomically when the LAST stage registers,
and the run rides the resilience layer's ``GangSupervisor``: one dead
stage kills the survivors (their channel recvs can never complete), so
the driver's ``get`` fails fast instead of waiting out a channel
timeout.

Port-only arguments, where the JAX package reads its environment or
speaks JAX:
- ``num_slices=`` takes the place of RAY_TPU_VIRTUAL_SLICES: stage s
  gets slice id ``s % num_slices``; the default is one slice per stage.
- ``device=`` ("cuda" by default, or one entry per stage) is where each
  stage computes. A CUDA stage's bundle and actor lease one whole GPU
  (as ``ScalingConfig.use_gpu`` does for a gang); a CPU stage's lease
  none. A pipeline asked for CUDA without CUDA raises.
- ``optimizer`` is a port optimizer (``init`` / ``update_``), built
  independently in every stage.
- ``stage_class=`` (default ``StageActor``) is the actor class each
  stage runs: a subclass may add methods, e.g. to read the kernels'
  launch counts in the stage's own process.
"""
from __future__ import annotations

import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..util.runtime import require_worker
from .schedule import SCHEDULES, bubble_fraction
from .stage import StageActor


def _stage_devices(device: Union[str, Sequence[str]],
                   num_stages: int) -> List[str]:
    """One device type per stage ("cuda" / "cpu"); CUDA only where it
    exists."""
    import torch

    devs = [device] * num_stages if isinstance(device, str) \
        else [str(d) for d in device]
    if len(devs) != num_stages:
        raise ValueError(f"{len(devs)} devices for {num_stages} stages")
    out = []
    for d in devs:
        kind = torch.device(d).type
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"stage device {d!r}: cpu or cuda")
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "pipeline's stages on the CPU")
        out.append(kind)
    return out


class PipelineConductor:
    """Forms and drives one named MPMD pipeline.

    stage_fns[i](params_i, x) -> y is stage i's forward;
    stage_params[i] its initial params (a tree of tensors or arrays). The
    last stage owns loss_fn(y_last, target) -> scalar. `optimizer` (a
    port optimizer) is instantiated independently per stage.
    """

    def __init__(self, name: str,
                 stage_fns: Sequence[Callable],
                 stage_params: Sequence[Any],
                 optimizer,
                 loss_fn: Callable, *,
                 num_microbatches: int,
                 schedule: str = "1f1b",
                 hosts_per_stage: int = 1,
                 resources_per_stage: Optional[Dict[str, float]] = None,
                 run_id: str = "",
                 num_slices: Optional[int] = None,
                 device: Union[str, Sequence[str]] = "cuda",
                 stage_class: type = StageActor):
        if len(stage_fns) != len(stage_params):
            raise ValueError(
                f"{len(stage_fns)} stage fns but "
                f"{len(stage_params)} stage param trees")
        if len(stage_fns) < 2:
            raise ValueError("an MPMD pipeline needs >= 2 stages; use "
                             "TorchTrainer/TrainStep for a single program")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"one of {sorted(SCHEDULES)}")
        if int(hosts_per_stage) != 1:
            # multi-host stage-gangs are a ROADMAP follow-up; refusing
            # beats silently spawning a single-process stage
            raise NotImplementedError(
                f"hosts_per_stage={hosts_per_stage}: stage-gangs run "
                "one host per stage today (multi-host stage-gangs are "
                "a ROADMAP follow-up)")
        self.name = name
        self.stage_fns = list(stage_fns)
        self.stage_params = list(stage_params)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.num_stages = len(stage_fns)
        self.num_microbatches = int(num_microbatches)
        self.schedule = schedule
        self.hosts_per_stage = int(hosts_per_stage)
        self.resources_per_stage = dict(resources_per_stage
                                        or {"CPU": 1.0})
        self.devices = _stage_devices(device, self.num_stages)
        self.num_slices = max(1, int(num_slices)) if num_slices \
            else self.num_stages
        self.stage_class = stage_class
        self.run_id = run_id or f"mpmd/{name}/{uuid.uuid4().hex[:8]}"
        self.bubble_estimate = bubble_fraction(
            schedule, self.num_stages, self.num_microbatches)
        self._worker = require_worker("forming a pipeline")
        self._actors: List[Any] = []
        self._pg = None

    # ----------------------------------------------------------- formation

    def form(self, timeout: float = 120.0) -> Dict[str, Any]:
        """Open the registry entry, spawn one stage-gang per slice, and
        block until every stage registered (the atomic "formed" commit).
        Lints the schedule first: a >20% analytic bubble is a warning
        naming the M >= 4*S rule."""
        import warnings

        from ..analysis import check_pipeline_schedule, errors, \
            format_report

        findings = check_pipeline_schedule(
            self.num_stages, self.num_microbatches, self.schedule,
            where=f"pipeline/{self.name}")
        if errors(findings):  # defensive: the rule never errors today
            raise ValueError(format_report(findings))
        if findings and any(f.severity == "warning" for f in findings):
            warnings.warn("shardlint: " + format_report(findings),
                          stacklevel=2)

        w = self._worker
        res = w.conductor.call(
            "pipeline_open", self.name,
            {"num_stages": self.num_stages,
             "schedule": self.schedule,
             "num_microbatches": self.num_microbatches,
             "bubble_estimate": self.bubble_estimate,
             "run_id": self.run_id}, timeout=30.0)
        if isinstance(res, dict) and res.get("error"):
            raise RuntimeError(f"pipeline_open rejected: {res['error']}")

        try:
            return self._form_gangs(timeout)
        except BaseException:
            # any formation failure (remote setup raised, registration
            # rejected, poll timeout) must not leak live stage actors,
            # the placement group, or a forever-"forming" registry entry
            self.close()
            raise

    def _bundle(self, s: int) -> Dict[str, float]:
        bundle = dict(self.resources_per_stage)
        if self.devices[s] == "cuda":
            bundle["GPU"] = bundle.get("GPU", 1.0)
        else:
            bundle.pop("GPU", None)
        return bundle

    def _form_gangs(self, timeout: float) -> Dict[str, Any]:
        from .. import get, remote
        from ..resilience.supervisor import GangSupervisor
        from ..util.placement_group import placement_group

        w = self._worker
        bundles = [self._bundle(s) for s in range(self.num_stages)]
        # one bundle per stage, SPREAD: stages land on distinct hosts
        # whenever capacity allows, so a stage really does share a
        # failure domain with nothing but itself (soft on one node)
        self._pg = placement_group(bundles, strategy="SPREAD")
        if not self._pg.wait(timeout):
            raise RuntimeError(
                f"pipeline {self.name!r}: the stages' bundles {bundles} "
                f"found no room within {timeout}s")
        remote_cls = remote(self.stage_class)

        def spawn(s: int):
            res = dict(bundles[s])
            opts: Dict[str, Any] = {"placement_group": self._pg,
                                    "num_cpus": res.pop("CPU", 1.0)}
            gpus = res.pop("GPU", 0)
            if gpus:
                opts["num_gpus"] = gpus
            if res:
                opts["resources"] = res
            return remote_cls.options(**opts).remote(
                self.name, s, self.num_stages,
                schedule=self.schedule,
                num_microbatches=self.num_microbatches,
                slice_id=s % self.num_slices, run_id=self.run_id,
                device=self.devices[s])

        # created at once: a creation returns once its actor is placed,
        # and each stage's process imports torch (a GPU one cold) first
        with ThreadPoolExecutor(self.num_stages) as pool:
            futures = [pool.submit(spawn, s)
                       for s in range(self.num_stages)]
        errors = [f.exception() for f in futures]
        self._actors = [f.result() for f, e in zip(futures, errors)
                        if e is None]
        if any(errors):
            raise next(e for e in errors if e is not None)
        setup_refs = [
            a.setup.remote(
                self.stage_fns[s], self.stage_params[s], self.optimizer,
                self.loss_fn if s == self.num_stages - 1 else None)
            for s, a in enumerate(self._actors)]
        with GangSupervisor(self._actors, run_id=self.run_id):
            registrations = get(setup_refs)
        rejected = [r for r in registrations
                    if isinstance(r, dict) and r.get("error")]
        if rejected:
            # a rejected registration (wrong generation, closed pipeline)
            # would otherwise burn the whole formation timeout
            raise RuntimeError(
                f"pipeline {self.name!r} stage registration rejected: "
                f"{rejected[0]['error']}")
        # the LAST registration flips formed=True atomically; poll only
        # as the safety net for out-of-order delivery
        deadline = time.monotonic() + timeout
        while True:
            rec = w.conductor.call("pipeline_get", self.name,
                                   timeout=10.0)
            if rec and rec.get("formed"):
                return rec
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pipeline {self.name!r} did not form within "
                    f"{timeout}s: "
                    f"{len((rec or {}).get('stages') or {})}/"
                    f"{self.num_stages} stages registered")
            time.sleep(0.05)

    # ----------------------------------------------------------------- run

    def run(self, num_steps: int, data_fn: Callable[[int], Any],
            recv_timeout: float = 60.0) -> Dict[str, Any]:
        """Drive `num_steps` pipeline steps across all stage-gangs under
        gang supervision. Returns {"losses": [...], "stages": [summary
        per stage]}; losses come from the last stage."""
        from .. import get
        from ..resilience.supervisor import GangSupervisor

        if not self._actors:
            self.form()
        refs = [a.run_steps.remote(num_steps, data_fn,
                                   recv_timeout=recv_timeout)
                for a in self._actors]
        try:
            with GangSupervisor(self._actors, run_id=self.run_id):
                summaries = get(refs)
        except Exception as e:
            # the survivors' channel recvs can never complete: kill them
            # (the supervisor does so when the death's notice arrives
            # before this get fails; a stage whose connection broke first
            # would outlive it) and mark the pipeline lane so the
            # timeline shows WHY the run stopped
            from .. import kill

            for a in self._actors:
                try:
                    kill(a)
                except Exception:  # noqa: BLE001 — already dead is fine
                    pass
            try:
                self._worker.conductor.notify("report_pipeline_event", {
                    "kind": "stage_death", "pipeline": self.name,
                    "detail": f"{type(e).__name__}: {e}"[:500]})
            except Exception:  # noqa: BLE001 — telemetry only
                pass
            raise
        return {"losses": summaries[-1].get("losses", []),
                "stages": summaries}

    def stage_params_snapshot(self) -> List[Any]:
        """Host copies of every stage's current params (test / debug)."""
        from .. import get

        return get([a.get_params.remote() for a in self._actors])

    # --------------------------------------------------------------- close

    def close(self) -> None:
        """Kill the stage-gangs, release their placement group, and
        close the registry entry."""
        from .. import kill

        for a in self._actors:
            try:
                kill(a)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        self._actors = []
        if self._pg is not None:
            from ..util.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001 — conductor mid-shutdown
                pass
            self._pg = None
        try:
            self._worker.conductor.call("pipeline_close", self.name,
                                        timeout=10.0)
        except Exception:  # noqa: BLE001 — conductor mid-shutdown
            pass

    def __enter__(self) -> "PipelineConductor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["PipelineConductor"]
