"""TrainStep (port of ray_tpu/train/trainer.py:142-325).

    step = TrainStep(lambda p, b: gpt2_loss(p, b["tokens"], b["targets"],
                                            cfg),
                     adamw(3e-4, weight_decay=0.1),
                     flops_per_token=train_flops_per_token(cfg, seq))
    state = step.init_state(params)
    for batch in batches:
        state, metrics = step(state, batch)

With `mesh=` (a `parallel.make_mesh` DeviceMesh) and `param_specs=`
(e.g. `models.gpt2.gpt2_partition_specs`) it is the mesh form: every
rank of the mesh runs the same calls on the same global batch. No
ahead-of-time compile: PyTorch runs eagerly.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)

from ..device import resolve_device
from ..observability import flops as _flops
from ..observability.step_timer import StepTimer
from ..parallel.mesh import (P, RowSplit, axis_names, map_specs,
                             mesh_sizes, spec_axes, spec_placements,
                             split_rows, validate_axis_names)
from ..parallel.shardcheck import check_specs
from ..tree import tree_leaves, tree_map
from .session import _get_session


def _batch_tokens(batch: Any) -> int:
    """Tokens per step: the first leaf with >= 2 dims contributes
    batch x seq; 0 when no such leaf exists."""
    for leaf in tree_leaves(batch):
        shape = getattr(leaf, "shape", ())
        if len(shape) >= 2:
            return int(shape[0]) * int(shape[1])
    return 0


class TrainStep:
    """One training step: loss, backward, optimizer update.

    loss_fn(params, batch) -> scalar tensor; optimizer has `init(params)`
    and `update_(grads, state, params)` (`train.optim.AdamW`).
    flops_per_token (e.g. `observability.flops.train_flops_per_token`)
    gives the analytic FLOPs per step for MFU. With a `timer`, each call
    records `data_wait` (moving the batch to the device) and
    `device_step` (the step, synchronised with the device: the
    measurement's cost; without a timer the step stays asynchronous);
    the caller closes each step with `timer.end_step()`. Without one,
    under a train session (`train.trainer.TorchTrainer`) the step records
    into the session's StepTimer, which `session.report()` closes, as
    the JAX package's step does; outside a session it records nothing.

    Params and optimizer moments are updated IN PLACE, and the state
    dict passed in is the one returned: this is the port's stand-in for
    JAX's donation of the old state, so a caller must not expect the
    previous step's tensors to survive a call.

    The mesh form (`mesh`, `param_specs`, `data_spec`) is JAX's SPMD
    step: every rank calls it with the same global batch.
    - `init_state` checks the specs against the mesh (`parallel.
      shardcheck.check_specs`: an unknown axis, a dim the axes do not
      divide, an axis used twice raise ValueError naming the parameter)
      and stores each parameter, and its AdamW moments, as a DTensor
      laid out by its spec; the optimizer updates each rank's blocks
      (ZeRO-3).
    - Each step gathers every parameter to a plain full tensor whose
      gradient is a partial sum over the data axes, so the backward
      reduce-scatters (or all-reduces) it into the parameter's layout.
      `loss_fn` runs on plain tensors (no DTensor reaches a kernel) and
      on this rank's rows of the batch: those of its coordinate on the
      axes of `data_spec`'s first entry, in the spec's order, as JAX
      lays out the batch. `loss_fn` must be a mean over equal rows: the
      step divides it by the number of row blocks, so the gradient and
      the returned loss are the global batch's mean, as JAX's. It runs
      under the split (`parallel.mesh.split_rows`): a loss that needs
      the whole batch reads `row_split()` and gathers it (the MoE
      model's routing does), and is then the global batch's as well.
    - tp, pp, sp and ep in a spec only decide where a parameter is
      stored: the step computes on gathered weights, so any mesh gives
      JAX's numbers, but tensor-parallel compute is not split yet.
    """

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 optimizer: Any, flops_per_token: Optional[float] = None,
                 device: Union[str, torch.device, None] = "cuda",
                 timer: Optional[StepTimer] = None,
                 mesh: Optional[DeviceMesh] = None,
                 param_specs: Any = None,
                 data_spec: P = P(("dp", "fsdp"))):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.flops_per_token = flops_per_token
        self.device = resolve_device(device)
        self.timer = timer
        self.mesh = mesh
        self.param_specs = param_specs
        self.data_spec = data_spec
        self._first = True
        if mesh is not None:
            self._init_mesh(mesh)

    def _init_mesh(self, mesh: DeviceMesh) -> None:
        if self.param_specs is None:
            raise ValueError("a mesh TrainStep needs param_specs")
        if mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type!r}, step on "
                             f"{self.device.type!r}")
        validate_axis_names(mesh, self.data_spec, "data_spec")
        if any(e is not None for e in self.data_spec[1:]):
            raise ValueError(f"data_spec {self.data_spec} splits a dim "
                             f"other than the batch")
        data_axes = spec_axes(self.data_spec[0]) if self.data_spec else ()
        self._split = RowSplit(mesh, data_axes)
        self._full = [Replicate()] * mesh.ndim
        self._partial = [Partial() if a in data_axes else Replicate()
                         for a in axis_names(mesh)]

    def init_state(self, params: Any) -> Dict[str, Any]:
        """Params moved to the step's device (a tensor already there is
        used as it is) and marked as requiring grad, and the optimizer's
        state for them. On a mesh, each parameter is distributed by its
        spec (rank 0's values), after the specs are checked."""
        def put(p: torch.Tensor) -> torch.Tensor:
            p = p.detach().to(self.device)
            return p.requires_grad_(p.is_floating_point())

        if self.mesh is None:
            params = tree_map(put, params)
        else:
            check_specs(self.param_specs, params, mesh_sizes(self.mesh))
            params = map_specs(lambda spec, p, _: distribute_tensor(
                p.detach().to(self.device), self.mesh,
                spec_placements(self.mesh, spec)).requires_grad_(
                    p.is_floating_point()), self.param_specs, params)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def _instrument(self, timer: StepTimer, batch: Any) -> None:
        """First-step hookup: tokens and analytic FLOPs per step, and the
        peak for MFU: the device's, times the mesh's ranks."""
        peak = _flops.device_peak_flops(self.device) \
            if self.device.type == "cuda" else None
        if peak is not None:
            timer.set_peak_flops(
                peak * (1 if self.mesh is None else self.mesh.size()))
        tokens = _batch_tokens(batch)
        if tokens:
            timer.set_tokens_per_step(tokens)
            if self.flops_per_token:
                timer.set_flops_per_step(self.flops_per_token * tokens)

    def _rows(self, x: Any) -> Any:
        """This rank's block of rows of a global batch leaf."""
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        if x.shape[0] % self._split.blocks:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {self._split.blocks} equal blocks")
        return self._split.own(x)

    def gathered(self, params: Any) -> Any:
        """A mesh state's parameters as plain full tensors, each on every
        rank, whose gradient is taken as a partial sum over the data
        axes: the backward reduces it across them into the parameter's
        layout. (`DTensor.full_tensor()` would take it as replicated and
        keep only this rank's data's share.)"""
        return tree_map(lambda p: p.redistribute(self.mesh, self._full)
                        .to_local(grad_placements=self._partial), params)

    def _timer(self) -> Optional[StepTimer]:
        timer = self.timer
        if timer is None:
            ctx = _get_session()
            timer = ctx._step_timer if ctx is not None else None
        return timer if timer is not None and timer.enabled else None

    def __call__(self, state: Dict[str, Any], batch: Any
                 ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        timer = self._timer()
        t0 = time.perf_counter()
        batch = tree_map(lambda x: x.to(self.device, non_blocking=True)
                         if isinstance(x, torch.Tensor) else x, batch)
        global_batch = batch
        if self.mesh is not None:
            batch = tree_map(self._rows, batch)
        if timer is not None:
            timer.record("data_wait", time.perf_counter() - t0)
            if self._first:
                self._instrument(timer, global_batch)
            t0 = time.perf_counter()
        self._first = False
        params = state["params"]
        leaves = tree_leaves(params)
        if self.mesh is None:
            loss = self.loss_fn(params, batch)
        else:
            with split_rows(self._split):
                loss = self.loss_fn(self.gathered(params), batch)
            loss = loss / self._split.blocks
        grads = torch.autograd.grad(loss, leaves)
        self.optimizer.update_(grads, state["opt_state"], params)
        # int(): a restored step is a numpy 0-d int64
        state["step"] = int(state["step"]) + 1
        loss = loss.detach()
        if self.mesh is not None:
            loss = DTensor.from_local(loss, self.mesh, self._partial,
                                      run_check=False).full_tensor()
        if timer is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timer.record("device_step", time.perf_counter() - t0)
        return state, {"loss": loss}
