"""Small runtime guards shared across subsystems (port of
ray_tpu/util/runtime.py)."""
from __future__ import annotations


def require_worker(what: str):
    """The connected global worker, or an error naming the operation that
    needed it. One implementation for every subsystem that fails without
    a cluster (the weight fabric, the pipeline channels, ...)."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError(
            f"ray_tpu_torch.init() must be called before {what}")
    return w


def pipeline_run_token(run_id: str) -> str:
    """One path-safe key segment for an MPMD pipeline generation ("/" is
    the channel-key separator). The one encoding both sides of the
    generation fence use: `mpmd.channels` builds keys with it and the
    conductor's `pipeline_channel_put` parses them against it."""
    return (run_id or "default").replace("/", ":")


__all__ = ["pipeline_run_token", "require_worker"]
