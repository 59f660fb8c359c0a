"""One MPMD pipeline stage: its own program on its own stage-gang (port
of ray_tpu/mpmd/stage.py).

``StageProgram`` is the per-stage ``TrainStep`` analog: it owns the
stage's params and optimizer state and runs the stage's OWN forward,
backward and, on the last stage, loss-and-grad, independently of every
other stage. That independence is the point of MPMD (arXiv 2412.14374):
no stage ever runs another stage's computation, and stages may be
heterogeneous (a CPU stage beside a CUDA one).

Where JAX traces a vjp, the port recomputes: a forward tick runs
``apply_fn`` under ``torch.no_grad()`` and keeps only the input; the
backward tick runs the forward again with autograd on and calls
``torch.autograd.grad`` with respect to the parameter leaves (and the
saved input when an upstream stage needs it), as JAX's ``jax.vjp``
inside its jitted backward does. Gradients accumulate in their own
dtype across microbatches; ``apply_update`` divides by M and takes one
optimizer step (a port optimizer's ``update_``, in place).

``run_stage`` executes the stage's schedule ticks against the
activation / gradient channels, accounting blocked-on-channel time to
the step timer's ``bubble_wait`` phase, so the merged timeline shows
each stage's bubble directly.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .channels import ActivationChannel
from .metrics import metrics_snapshot, pipeline_metrics
from .schedule import FORWARD, stage_schedule


def _to_device(tree: Any, device: Any) -> Any:
    """Every leaf as a tensor on `device` (numpy leaves copied in)."""
    def put(leaf):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.array(leaf))
        return leaf.to(device)

    return tree_map(put, tree)


class StageProgram:
    """Programs and state of one stage.

    apply_fn(params, x) -> y is this stage's forward. The LAST stage
    additionally owns loss_fn(y, target) -> scalar and runs one
    loss-and-grad program instead of a separate forward / backward pair
    (in 1F1B its backward follows its forward immediately). `params` is
    a tree of tensors on the stage's device; `optimizer` a port optimizer
    (``init`` / ``update_``: ``train.optim.sgd``, ``adamw``,
    ``frozen_adam``)."""

    def __init__(self, apply_fn: Callable, params: Any, optimizer,
                 *, loss_fn: Optional[Callable] = None,
                 is_last: bool = False,
                 needs_input_grad: bool = True,
                 num_microbatches: int = 1):
        self.apply_fn = apply_fn
        self.params = params
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.is_last = bool(is_last)
        self.needs_input_grad = bool(needs_input_grad)
        self.num_microbatches = int(num_microbatches)
        if self.is_last and loss_fn is None:
            raise ValueError("the last stage needs a loss_fn")
        self.opt_state = optimizer.init(params)
        self._saved: Dict[int, Any] = {}  # mb -> forward input
        self._grad_acc: Optional[List[torch.Tensor]] = None

    # ------------------------------------------------------------- ticks

    def forward(self, mb: int, x: Any) -> Any:
        """Run this stage's forward on microbatch `mb`, saving the input
        for the backward. Last-stage forwards only save (its
        loss-and-grad recomputes the forward with the target in hand)."""
        self._saved[mb] = x
        if self.is_last:
            return None
        with torch.no_grad():
            return self.apply_fn(self.params, x)

    def _vjp(self, x: Any, dy: Any = None, target: Any = None):
        """(loss or None, param grads in `tree_leaves(params)` order, the
        input's gradient tree or None): the forward recomputed with
        autograd on, then one `torch.autograd.grad`. Stage 0's input is
        token ids: it never asks for dX (JAX drops that chain too)."""
        p_leaves = tree_leaves(self.params)
        with torch.enable_grad():
            p_req = [t.detach().requires_grad_(True) for t in p_leaves]
            p = tree_unflatten_like(self.params, p_req)
            x_leaves, x_struct = tree_flatten(x)
            x_req: List[Any] = list(x_leaves)
            want_x = []
            if self.needs_input_grad:
                for i, leaf in enumerate(x_leaves):
                    if isinstance(leaf, torch.Tensor) and \
                            leaf.is_floating_point():
                        x_req[i] = leaf.detach().requires_grad_(True)
                        want_x.append(i)
            xx = tree_unflatten(x_struct, x_req)
            inputs = p_req + [x_req[i] for i in want_x]
            if self.is_last:
                loss = self.loss_fn(self.apply_fn(p, xx), target)
                grads = torch.autograd.grad(loss, inputs,
                                            allow_unused=True)
                loss = loss.detach()
            else:
                loss = None
                y = tree_leaves(self.apply_fn(p, xx))
                grads = torch.autograd.grad(y, inputs, tree_leaves(dy),
                                            allow_unused=True)
        # an unused parameter's gradient is zero, as jax.vjp gives it
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(inputs, grads)]
        gp = grads[:len(p_req)]
        gx = None
        if self.needs_input_grad:
            gx_leaves: List[Any] = [None] * len(x_leaves)
            for i, g in zip(want_x, grads[len(p_req):]):
                gx_leaves[i] = g
            gx = tree_unflatten(x_struct, gx_leaves)
        return loss, gp, gx

    def backward(self, mb: int, dy: Any = None,
                 target: Any = None) -> Any:
        """Run the backward for microbatch `mb`. Mid / first stages take
        the downstream gradient `dy`; the last stage takes `target` and
        returns (loss, upstream_grad); others return upstream_grad.
        Accumulates this stage's param grads in their own dtype."""
        x = self._saved.pop(mb)
        loss, gp, gx = self._vjp(x, dy=dy, target=target)
        if self._grad_acc is None:
            self._grad_acc = gp
        else:
            self._grad_acc = [a + b for a, b in zip(self._grad_acc, gp)]
        return (loss, gx) if self.is_last else gx

    def apply_update(self) -> None:
        """One optimizer step from the accumulated microbatch grads."""
        if self._grad_acc is None:
            raise RuntimeError("apply_update before any backward")
        m = float(self.num_microbatches)
        grads = [g / m for g in self._grad_acc]
        self.optimizer.update_(grads, self.opt_state, self.params)
        self._grad_acc = None

    def reset_step_state(self) -> None:
        """Drop partial per-step state (saved activations, accumulated
        grads). Called at run start so a retry on a still-live actor,
        after an aborted run raised mid-step, can never average a dead
        step's partial gradient sums into its first update."""
        self._saved.clear()
        self._grad_acc = None

    @property
    def live_activations(self) -> int:
        return len(self._saved)


def tree_unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """`leaves` (in `tree_leaves(tree)` order) put back into `tree`'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _leaf: next(it), tree)


def _stage_device(program: StageProgram) -> torch.device:
    """Where the stage computes: its first parameter's device."""
    leaves = tree_leaves(program.params)
    return leaves[0].device if leaves else torch.device("cpu")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stage(program: StageProgram, *, name: str, stage: int,
              num_stages: int, schedule: str, num_microbatches: int,
              num_steps: int, data_fn: Callable[[int], Any],
              timer=None, recv_timeout: float = 60.0,
              run_id: str = "",
              poll_interval: float = 0.25) -> Dict[str, Any]:
    """Drive one stage through `num_steps` pipeline steps.

    data_fn(step) -> (x, target): the deterministic per-step batch
    source every stage shares (stage 0 consumes x, the last stage
    consumes target; mid stages call it for neither). Returns the stage
    summary (losses on the last stage, channel stats, bubble fraction).
    On a CUDA stage every compute tick is synchronized before it is
    timed, so the phases hold the device's time, not the launch's.
    """
    import contextlib

    def bubble_cm():
        return (timer.phase("bubble_wait") if timer is not None
                else contextlib.nullcontext())

    s, last = int(stage), int(stage) == int(num_stages) - 1
    device = _stage_device(program)
    program.reset_step_state()  # a retried run must start clean
    ticks = stage_schedule(schedule, s, num_stages, num_microbatches)
    in_ch = out_ch = gin_ch = gout_ch = None
    kw = dict(stage=s, run_id=run_id, poll_interval=poll_interval,
              device=device)
    if s > 0:
        in_ch = ActivationChannel(name, s - 1, s, **kw)
        gout_ch = ActivationChannel(name, s, s - 1, **kw)
    if not last:
        out_ch = ActivationChannel(name, s, s + 1, **kw)
        gin_ch = ActivationChannel(name, s + 1, s, **kw)

    losses: List[float] = []
    bubble_fracs: List[float] = []

    def prefetch_next(idx: int, step: int) -> None:
        """Start the NEXT recv-needing tick's channel pull now, so it
        streams during this tick's compute (channels.prefetch, the
        bubble_wait shrinker; within-step only, the sender may not exist
        across a step boundary yet)."""
        for t in ticks[idx + 1:]:
            if t.op == FORWARD:
                if s > 0:
                    in_ch.prefetch(step, t.mb, "act",
                                   timeout=recv_timeout)
                    return
            elif not last:
                gin_ch.prefetch(step, t.mb, "grad",
                                timeout=recv_timeout)
                return
    # the first call of each program is attributed to the compile phase
    # (JAX's trace and compile; here the first call's allocations and
    # kernel loads); every later call is device_step
    compiled = {"fwd": False, "bwd": False}

    def compute_phase(kind: str) -> str:
        if compiled[kind]:
            return "device_step"
        compiled[kind] = True
        return "compile"

    t_run0 = time.perf_counter()
    try:
        for step in range(int(num_steps)):
            t_step0 = time.perf_counter()
            bubble_s = 0.0
            micro_x = micro_t = None
            if s == 0 or last:
                x_full, t_full = data_fn(step)
                if s == 0:
                    micro_x = _split_microbatches(x_full,
                                                  num_microbatches)
                if last:
                    micro_t = _split_microbatches(t_full,
                                                  num_microbatches)
            step_losses: List[Any] = []
            for tick_idx, tick in enumerate(ticks):
                if tick.op == FORWARD:
                    if s == 0:
                        x = _to_device(
                            tree_map(lambda a: a[tick.mb], micro_x),
                            device)
                    else:
                        t0 = time.perf_counter()
                        with bubble_cm():
                            x = in_ch.recv(step, tick.mb, "act",
                                           timeout=recv_timeout)
                        bubble_s += time.perf_counter() - t0
                        prefetch_next(tick_idx, step)
                    t0 = time.perf_counter()
                    y = program.forward(tick.mb, x)
                    _synchronize(device)
                    if timer is not None:
                        # last-stage forwards only save (no program
                        # ran), so they never consume the compile slot
                        timer.record(
                            compute_phase("fwd") if not last
                            else "device_step",
                            time.perf_counter() - t0)
                    if out_ch is not None:
                        out_ch.send(step, tick.mb, "act", y)
                else:
                    if last:
                        tgt = _to_device(
                            tree_map(lambda a: a[tick.mb], micro_t),
                            device)
                        t0 = time.perf_counter()
                        loss, gx = program.backward(tick.mb,
                                                    target=tgt)
                        _synchronize(device)
                        if timer is not None:
                            timer.record(compute_phase("bwd"),
                                         time.perf_counter() - t0)
                        step_losses.append(loss)
                    else:
                        t0 = time.perf_counter()
                        with bubble_cm():
                            dy = gin_ch.recv(step, tick.mb, "grad",
                                             timeout=recv_timeout)
                        bubble_s += time.perf_counter() - t0
                        prefetch_next(tick_idx, step)
                        t0 = time.perf_counter()
                        gx = program.backward(tick.mb, dy=dy)
                        _synchronize(device)
                        if timer is not None:
                            timer.record(compute_phase("bwd"),
                                         time.perf_counter() - t0)
                    if gout_ch is not None:
                        gout_ch.send(step, tick.mb, "grad", gx)
            t0 = time.perf_counter()
            program.apply_update()
            _synchronize(device)
            if timer is not None:
                timer.record("device_step", time.perf_counter() - t0)
            step_s = time.perf_counter() - t_step0
            frac = min(1.0, bubble_s / step_s) if step_s > 0 else 0.0
            bubble_fracs.append(frac)
            pipeline_metrics()["bubble_fraction"].set(
                frac, tags={"pipeline": name, "stage": str(s)})
            if last and step_losses:
                losses.append(float(np.mean(
                    [float(v) for v in step_losses])))
            if timer is not None:
                timer.end_step()
        # success path: wait for the neighbors to TAKE the final step's
        # payloads before close() drops the chunk refs (the refs are the
        # chunks' lifetime)
        for ch in (out_ch, gout_ch):
            if ch is not None:
                ch.drain(timeout=max(10.0, recv_timeout / 2))
    finally:
        for ch in (in_ch, out_ch, gin_ch, gout_ch):
            if ch is not None:
                ch.close()
    chans = [c for c in (in_ch, out_ch, gin_ch, gout_ch)
             if c is not None]
    summary: Dict[str, Any] = {
        "stage": s,
        "run_id": run_id,  # generation fencing at report time
        "steps": int(num_steps),
        "ticks_per_step": len(ticks),
        "losses": losses,
        "bubble_fraction": (sum(bubble_fracs) / len(bubble_fracs)
                            if bubble_fracs else 0.0),
        "last_bubble_fraction": (bubble_fracs[-1] if bubble_fracs
                                 else 0.0),
        "sent_bytes": sum(c.stats.sent_bytes for c in chans),
        "recv_bytes": sum(c.stats.recv_bytes for c in chans),
        "sent_msgs": sum(c.stats.sent_msgs for c in chans),
        "recv_msgs": sum(c.stats.recv_msgs for c in chans),
        "prefetch_hits": sum(c.stats.prefetch_hits for c in chans),
        "channel_wait_s": sum(c.stats.wait_s for c in chans),
        "elapsed_s": time.perf_counter() - t_run0,
    }
    return summary


def _split_microbatches(batch: Any, m: int) -> Any:
    """Reshape every leaf [B, ...] -> [m, B/m, ...]; validates
    divisibility with the batch named."""
    def split(a):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        if a.shape[0] % m != 0:
            raise ValueError(
                f"batch {a.shape[0]} not divisible by "
                f"num_microbatches {m}")
        return a.reshape(m, a.shape[0] // m, *a.shape[1:])

    return tree_map(split, batch)


class StageActor:
    """The stage-gang member actor (wrapped with ``remote`` by the
    PipelineConductor). One actor per stage host; it registers the stage
    with the conductor's pipeline registry. `device` is where the stage
    computes: "cuda" on an actor holding a GPU lease, else "cpu"."""

    def __init__(self, name: str, stage: int, num_stages: int, *,
                 schedule: str, num_microbatches: int,
                 slice_id: Optional[int] = None, run_id: str = "",
                 device: str = "cpu"):
        self.name = name
        self.stage = int(stage)
        self.num_stages = int(num_stages)
        self.schedule = schedule
        self.num_microbatches = int(num_microbatches)
        self.slice_id = self.stage if slice_id is None else int(slice_id)
        self.run_id = run_id or f"mpmd/{name}"
        self.device = device
        self._program: Optional[StageProgram] = None

    def setup(self, apply_fn: Callable, init_params: Any, optimizer,
              loss_fn: Optional[Callable] = None) -> Dict[str, Any]:
        """Move the params to the stage's device, build this stage's own
        program and register the stage-gang with the conductor. Returns
        the registration result ({"formed": bool, ...})."""
        import os

        from ..device import resolve_device
        from ..util.runtime import require_worker

        device = resolve_device(self.device)
        self._program = StageProgram(
            apply_fn, _to_device(init_params, device), optimizer,
            loss_fn=loss_fn,
            is_last=self.stage == self.num_stages - 1,
            needs_input_grad=self.stage > 0,
            num_microbatches=self.num_microbatches)
        w = require_worker("registering a pipeline stage")
        info = {"worker_id": getattr(w, "worker_id", None),
                "slice_id": self.slice_id,
                "run_id": self.run_id,
                "device": str(device),
                "pid": os.getpid()}
        return w.conductor.call("pipeline_register_stage", self.name,
                                self.stage, info, timeout=30.0)

    def run_steps(self, num_steps: int, data_fn: Callable[[int], Any],
                  recv_timeout: float = 60.0) -> Dict[str, Any]:
        """Execute `num_steps` pipeline steps of this stage's schedule
        and report the stage summary (registry stats with this process's
        metric snapshot, step records, a timeline marker)."""
        from ..observability.step_timer import StepTimer
        from ..util.runtime import require_worker

        if self._program is None:
            raise RuntimeError("setup() must run before run_steps()")
        timer = StepTimer(self.run_id, rank=self.stage,
                          world_size=self.num_stages)
        try:
            summary = run_stage(
                self._program, name=self.name, stage=self.stage,
                num_stages=self.num_stages, schedule=self.schedule,
                num_microbatches=self.num_microbatches,
                num_steps=num_steps, data_fn=data_fn, timer=timer,
                recv_timeout=recv_timeout, run_id=self.run_id)
        finally:
            timer.close()
        summary["metrics"] = metrics_snapshot()
        # the same values reach Prometheus with the report, not at the
        # registry's next interval (a closed stage never gets one)
        from ..util import metrics

        metrics.flush()
        w = require_worker("reporting a pipeline stage")
        # the registry copy stays O(1) per stage: the full per-step loss
        # list rides the run_steps return value to the driver, only the
        # final loss goes to the record
        reg_stats = {k: v for k, v in summary.items() if k != "losses"}
        if summary.get("losses"):
            reg_stats["last_loss"] = summary["losses"][-1]
        try:
            w.conductor.call("report_pipeline_stats", self.name,
                             self.stage, reg_stats, timeout=10.0)
            w.conductor.notify("report_pipeline_event", {
                "kind": "stage_report", "pipeline": self.name,
                "stage": self.stage, "steps": summary["steps"],
                "bubble_fraction": round(summary["bubble_fraction"], 6),
                "sent_bytes": summary["sent_bytes"],
                "recv_bytes": summary["recv_bytes"]})
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        return summary

    def get_params(self) -> Any:
        """This stage's current params as host (CPU) copies."""
        return tree_map(lambda t: t.detach().to("cpu", copy=True),
                        self._program.params)
