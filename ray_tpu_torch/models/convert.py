"""Carry a JAX parameter pytree (leaves converted with `np.asarray`) into
the port's parameter dict: same keys, same layouts, one copy per leaf."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device


def _leaf(arr: Any, device: torch.device,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 comes from ml_dtypes, which torch cannot read:
        # carry the raw bits over and reinterpret them
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree: Any, device: Any = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts / lists / tuples of arrays -> the same structure of
    tensors on `device`, cast to `dtype` when given."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _leaf(node, dev, dtype)

    return walk(tree)
