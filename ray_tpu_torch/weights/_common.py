"""Shared internals of the weight fabric."""
from __future__ import annotations


def require_worker(what: str):
    """The connected global worker, or an error naming the operation that
    needed it."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError(
            f"ray_tpu_torch.init() must be called before {what}")
    return w
