"""AdamW with `optax.adamw`'s semantics and defaults, in place, an Adam
whose frozen top-level leaves get no update and no state, and plain SGD.

optax.adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
weight_decay=1e-4) is the chain scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate; `AdamW.update_` runs the same operations in the
same order on every leaf (no mask: biases, layer norms and `wte` decay
too):

    count += 1
    mu = b1 mu + (1 - b1) g
    nu = b2 nu + (1 - b2) g^2
    u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + eps_root) + eps)
    u += weight_decay p
    p += -learning_rate u

The moments are kept in each parameter's dtype, as optax keeps them with
mu_dtype=None, and the arithmetic runs in that dtype too. Where optax
returns new arrays, this updates params and moments in place (the port's
stand-in for JAX's buffer donation), with PyTorch's multi-tensor
(`_foreach`) operations over all leaves at once. DTensor params and
moments (the mesh form of `train.step.TrainStep`) are updated on each
rank's blocks: the ZeRO-3 update.

`FrozenAdam` is what the JAX package's online loop builds with
``optax.multi_transform({"train": optax.adam(lr), "freeze":
optax.set_to_zero()}, label_fn)``: the Adam update above with weight
decay 0 on every leaf under a top-level key not in `frozen`, and nothing
at all on the others: they keep no moments and stay bit-identical across
steps (which is what lets a delta publication skip them).

`SGD` is `optax.sgd(learning_rate)` with no momentum and no decay:
``p += -learning_rate g``, in the parameter's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import torch
from torch.distributed.tensor import DTensor

from ..tree import tree_leaves, tree_map


def _local(tensors: Sequence[torch.Tensor]) -> list:
    """Plain tensors: a DTensor's block on this rank (its storage, so the
    in-place update lands in the DTensor)."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


@dataclass(frozen=True)
class AdamW:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4

    def init(self, params: Any) -> Dict[str, Any]:
        """Zero moments shaped, typed and placed like `params`."""
        zeros = lambda p: torch.zeros_like(p, memory_format=  # noqa: E731
                                           torch.contiguous_format)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update_(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
                params: Any) -> None:
        """One step: `grads` in the order of `tree_leaves(params)`;
        `state` (from `init`) and `params` are updated in place."""
        ps, g = _local(tree_leaves(params)), _local(grads)
        mu, nu = _local(tree_leaves(state["mu"])), \
            _local(tree_leaves(state["nu"]))
        if not len(g) == len(ps) == len(mu) == len(nu):
            raise ValueError(f"{len(g)} grads for {len(ps)} params")
        # int(): a restored count is a numpy 0-d int64
        t = state["count"] = int(state["count"]) + 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        mu_hat = torch._foreach_div(mu, 1 - self.b1 ** t)
        den = torch._foreach_div(nu, 1 - self.b2 ** t)
        if self.eps_root:
            torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        if self.weight_decay:
            torch._foreach_add_(mu_hat, ps, alpha=self.weight_decay)
        torch._foreach_add_(ps, mu_hat, alpha=-self.learning_rate)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> AdamW:
    """`optax.adamw` with its defaults (weight_decay 1e-4, not
    torch.optim.AdamW's 1e-2)."""
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay)


@dataclass(frozen=True)
class FrozenAdam:
    learning_rate: float
    frozen: tuple = ()
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def _adam(self) -> AdamW:
        return AdamW(self.learning_rate, self.b1, self.b2, self.eps,
                     self.eps_root, weight_decay=0.0)

    def trained(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The top-level entries the optimizer updates."""
        return {k: v for k, v in params.items() if k not in self.frozen}

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Zero moments for the trained entries only."""
        return self._adam().init(self.trained(params))

    def update_(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
                params: Dict[str, Any]) -> None:
        """One step: `grads` in the order of `tree_leaves(params)` (a
        frozen leaf's gradient is ignored); the trained leaves and their
        moments are updated in place."""
        grads = list(grads)
        kept, i = [], 0
        for k, v in params.items():
            n = len(tree_leaves(v))
            if k not in self.frozen:
                kept.extend(grads[i:i + n])
            i += n
        if i != len(grads):
            raise ValueError(f"{len(grads)} grads for {i} params")
        self._adam().update_(kept, state, self.trained(params))


def frozen_adam(learning_rate: float, frozen: Sequence[str] = (),
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0) -> FrozenAdam:
    """`optax.adam` on every top-level entry not in `frozen`,
    `optax.set_to_zero` on those."""
    return FrozenAdam(learning_rate, tuple(frozen), b1, b2, eps, eps_root)


@dataclass(frozen=True)
class SGD:
    learning_rate: float

    def init(self, params: Any) -> Dict[str, Any]:
        """No state: `optax.sgd` without momentum keeps none."""
        return {}

    @torch.no_grad()
    def update_(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
                params: Any) -> None:
        """One step: `grads` in the order of `tree_leaves(params)`;
        `params` are updated in place."""
        ps, g = _local(tree_leaves(params)), _local(grads)
        if len(g) != len(ps):
            raise ValueError(f"{len(g)} grads for {len(ps)} params")
        # optax's two roundings: u = -lr g, then p + u
        torch._foreach_add_(ps, torch._foreach_mul(g, -self.learning_rate))


def sgd(learning_rate: float) -> SGD:
    """`optax.sgd(learning_rate)`: no momentum, no weight decay."""
    return SGD(learning_rate)
