"""AdamW with `optax.adamw`'s semantics and defaults, in place.

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
(`_foreach`) operations over all leaves at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import torch

from ..tree import tree_leaves, tree_map


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
        ps = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        g = list(grads)
        if not len(g) == len(ps) == len(mu) == len(nu):
            raise ValueError(f"{len(g)} grads for {len(ps)} params")
        state["count"] += 1
        t = state["count"]
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
