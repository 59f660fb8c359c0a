"""Best-effort pushes of the online loop to the conductor."""
from __future__ import annotations

from typing import Any, Dict


def notify(method: str, *args: Any) -> None:
    """`conductor.notify(method, *args)`; nothing without a cluster."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        return
    try:
        w.conductor.notify(method, *args)
    except Exception:  # noqa: BLE001 — cluster shutting down
        pass


def push_stats(component_id: str, stats: Dict[str, Any]) -> None:
    """A component's snapshot for `util.state.online_status()`."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is not None:
        notify("report_online_stats", w.worker_id, component_id, stats)


def event(ev: Dict[str, Any]) -> None:
    """An instant marker of the timeline's online lane."""
    notify("report_online_event", dict(ev))
