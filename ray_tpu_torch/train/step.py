"""TrainStep on one device (port of ray_tpu/train/trainer.py:142-325).

    step = TrainStep(lambda p, b: gpt2_loss(p, b["tokens"], b["targets"],
                                            cfg),
                     adamw(3e-4, weight_decay=0.1),
                     flops_per_token=train_flops_per_token(cfg, seq))
    state = step.init_state(params)
    for batch in batches:
        state, metrics = step(state, batch)

No mesh, sharding, shardlint or ahead-of-time compile yet: those come
with the port of `parallel/`.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..device import resolve_device
from ..observability import flops as _flops
from ..observability.step_timer import StepTimer
from ..tree import tree_leaves, tree_map


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
    the caller closes each step with `timer.end_step()`.

    Params and optimizer moments are updated IN PLACE, and the state
    dict passed in is the one returned: this is the port's stand-in for
    JAX's donation of the old state, so a caller must not expect the
    previous step's tensors to survive a call.
    """

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 optimizer: Any, flops_per_token: Optional[float] = None,
                 device: Union[str, torch.device, None] = "cuda",
                 timer: Optional[StepTimer] = None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.flops_per_token = flops_per_token
        self.device = resolve_device(device)
        self.timer = timer
        self._first = True

    def init_state(self, params: Any) -> Dict[str, Any]:
        """Params moved to the step's device (a tensor already there is
        used as it is) and marked as requiring grad, and the optimizer's
        state for them."""
        def put(p: torch.Tensor) -> torch.Tensor:
            p = p.detach().to(self.device)
            return p.requires_grad_(p.is_floating_point())

        params = tree_map(put, params)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def _instrument(self, timer: StepTimer, batch: Any) -> None:
        """First-step hookup: tokens and analytic FLOPs per step, and the
        device's peak for MFU."""
        if self.device.type == "cuda":
            timer.set_peak_flops(_flops.device_peak_flops(self.device))
        tokens = _batch_tokens(batch)
        if tokens:
            timer.set_tokens_per_step(tokens)
            if self.flops_per_token:
                timer.set_flops_per_step(self.flops_per_token * tokens)

    def __call__(self, state: Dict[str, Any], batch: Any
                 ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        timer = self.timer
        t0 = time.perf_counter()
        batch = tree_map(lambda x: x.to(self.device, non_blocking=True)
                         if isinstance(x, torch.Tensor) else x, batch)
        if timer is not None:
            timer.record("data_wait", time.perf_counter() - t0)
            if self._first:
                self._instrument(timer, batch)
            t0 = time.perf_counter()
        self._first = False
        params = state["params"]
        leaves = tree_leaves(params)
        loss = self.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        self.optimizer.update_(grads, state["opt_state"], params)
        state["step"] += 1
        if timer is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timer.record("device_step", time.perf_counter() - t0)
        return state, {"loss": loss.detach()}
