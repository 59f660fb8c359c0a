"""Carry JAX state into the port: a parameter pytree (leaves converted
with `np.asarray`) into the port's parameter dict — same keys, same
layouts, one copy per leaf — and an `optax.adamw` state into the port's
AdamW state, so a JAX training run can continue in the port."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..tree import is_node, rebuild, tree_map


def numpy_tensor(arr: Any) -> torch.Tensor:
    """A numpy array (or anything `np.asarray` takes) as a CPU tensor of
    the same dtype, on a copy of its memory."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 comes from ml_dtypes, which torch cannot read:
        # carry the raw bits over and reinterpret them
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _leaf(arr: Any, device: torch.device,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = numpy_tensor(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree: Any, device: Any = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts / lists / tuples of arrays -> the same structure of
    tensors on `device`, cast to `dtype` when given."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _leaf(leaf, dev, dtype), tree)


def from_jax_adamw_state(opt_state: Any, like_params: Any,
                         device: Any = "cuda") -> Dict[str, Any]:
    """`optax.adamw`'s state (its chain's `ScaleByAdamState(count, mu,
    nu)`, leaves converted with `np.asarray`) -> the port's AdamW state
    {"count", "mu", "nu"}, each moment leaf on `device` in the dtype of
    the matching leaf of `like_params`."""
    dev = resolve_device(device)
    chain = opt_state if isinstance(opt_state, tuple) \
        and not hasattr(opt_state, "mu") else (opt_state,)
    adam = next((s for s in chain if hasattr(s, "mu")), None)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in opt_state")

    def moment(like, src):
        # walk like_params, so the moments keep its keys and leaf order
        if isinstance(like, dict) and is_node(like):
            return rebuild(like, ((k, moment(v, src[k]))
                                  for k, v in like.items()))
        if is_node(like):
            return rebuild(like, [moment(v, s) for v, s in zip(like, src)])
        if tuple(np.shape(src)) != tuple(like.shape):
            raise ValueError(f"moment shape {np.shape(src)} does not "
                             f"match parameter {tuple(like.shape)}")
        return _leaf(src, dev, like.dtype)

    return {"count": int(np.asarray(adam.count)),
            "mu": moment(like_params, adam.mu),
            "nu": moment(like_params, adam.nu)}
