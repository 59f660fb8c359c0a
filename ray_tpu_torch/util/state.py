"""Cluster state views (part of the port of ray_tpu/util/state.py): the
weight fabric's registry and the recovery subsystem. The rest of that
module (task, actor and serving views, the merged timeline export) waits
for ROADMAP Queue 1 item 8; so do the CLI and dashboard surfaces of
these two views.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def _worker():
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    return w


def weight_versions(name: Optional[str] = None) -> Dict[str, Any]:
    """The live weight fabric's registry: per name the latest committed
    version and the kept manifests' summaries (version, step, run_id,
    bytes, host, leaf and chunk counts), plus the publishes still
    pending. `name` filters to one weight set."""
    out = _worker().conductor.call("get_weight_versions", timeout=10.0)
    if name is not None:
        out = {"names": {k: v for k, v in out.get("names", {}).items()
                         if k == name},
               "pending": [p for p in out.get("pending", [])
                           if p.get("name") == name]}
    return out


def resilience_status() -> Dict[str, Any]:
    """The recovery subsystem: per-host failure scores with quarantine
    and drain flags, the excluded hosts, event counters (preemption,
    restart, quarantine, grace_checkpoint, ...), the last time to
    recovery and the most recent events."""
    return _worker().conductor.call("get_resilience_status", timeout=10.0)


__all__ = ["resilience_status", "weight_versions"]
