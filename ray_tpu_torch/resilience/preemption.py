"""Preemption watcher: the node-side half of graceful preemption (the
port's copy of the JAX package's resilience/preemption.py).

A host learns that it is about to be reclaimed two ways: a maintenance
notice with a grace window, and plain SIGTERM when the platform starts
reclaiming the machine. This module stands in for both with portable
channels:

- a maintenance-event file: when it appears, the host is being
  preempted. It may be empty (defaults apply) or JSON ``{"grace_s": 30,
  "reason": "maintenance"}``. The JAX package names the file in the
  RAY_TPU_MAINTENANCE_EVENT environment variable; the port reads no
  such variable, and the file is an argument: ``NodeAgent(
  maintenance_event=PATH)``, ``python -m ray_tpu_torch start
  --maintenance-event PATH``, ``start_head(maintenance_event=PATH)``.
  Its default, None, is the knob's default: no channel.
- ``install_sigterm_notifier`` chains a SIGTERM handler in daemon
  processes (the node agent) so a platform kill becomes a conductor
  notification before the process dies.

Either way the payload is the same: the watcher calls ``notify(event)``
once per event, and the node agent forwards it to the conductor's
``report_preemption``, which broadcasts "checkpoint now, you have N
seconds" on the ``resilience`` channel and starts draining the host.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


def _default_grace() -> float:
    from .._private.config import config

    return config.preempt_grace_s


def _default_poll() -> float:
    from .._private.config import config

    return config.maintenance_poll_s


@dataclass
class MaintenanceEvent:
    grace_s: float
    reason: str = "maintenance"
    raw: Optional[dict] = None


def read_maintenance_event(spec: Optional[str]
                           ) -> Optional[MaintenanceEvent]:
    """Parse the maintenance channel once. `spec` is the file path
    (None: no channel); returns None when no event is pending. A
    malformed file still signals — a preemption notice must never be
    dropped over a JSON typo."""
    if not spec:
        return None
    if not os.path.exists(spec):
        return None
    raw: Optional[dict] = None
    try:
        with open(spec) as f:
            text = f.read().strip()
        if text:
            raw = json.loads(text)
    except (OSError, ValueError):
        raw = None
    grace = _default_grace()
    reason = "maintenance"
    if isinstance(raw, dict):
        try:
            grace = float(raw.get("grace_s", grace))
        except (TypeError, ValueError):
            pass
        reason = str(raw.get("reason", reason))
    return MaintenanceEvent(grace_s=grace, reason=reason, raw=raw)


class PreemptionWatcher:
    """Polls the maintenance channel `spec` and fires `notify(event)`
    once per event (re-arming only after the file disappears, so a
    lingering notice file does not re-broadcast every poll)."""

    def __init__(self, notify: Callable[[MaintenanceEvent], None],
                 spec: Optional[str] = None,
                 poll_s: Optional[float] = None):
        self._notify = notify
        self._spec = spec
        self._poll_s = poll_s
        self._stopped = threading.Event()
        self._fired = False
        self._thread = threading.Thread(
            target=self._loop, name="preemption-watcher", daemon=True)

    def start(self) -> "PreemptionWatcher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()

    def poll_once(self) -> Optional[MaintenanceEvent]:
        """One poll step (the loop body, exposed for tests): returns the
        event when this call fired the notification."""
        ev = read_maintenance_event(self._spec)
        if ev is None:
            self._fired = False  # channel cleared: re-arm
            return None
        if self._fired:
            return None
        self._fired = True
        try:
            self._notify(ev)
        except Exception:  # noqa: BLE001 — a flaky notify must not
            self._fired = False  # lose the event; retry next poll
            return None
        return ev

    def _loop(self) -> None:
        while not self._stopped.wait(self._poll_s or _default_poll()):
            self.poll_once()


def install_sigterm_notifier(notify: Callable[[MaintenanceEvent], None],
                             grace_s: Optional[float] = None):
    """Chain a SIGTERM handler that reports a preemption (then calls any
    previously-installed handler). For daemon mains only — a library
    must not hijack its host process's signals. Returns the previous
    handler."""
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        try:
            notify(MaintenanceEvent(
                grace_s=grace_s if grace_s is not None else _default_grace(),
                reason="sigterm"))
        except Exception:  # noqa: BLE001 — dying anyway; don't mask prev
            pass
        if callable(prev):
            prev(signum, frame)
        elif prev != signal.SIG_IGN:
            # previous disposition was the default (terminate): restore
            # it and re-raise so the process still dies — notifying must
            # not turn `kill`/`systemctl stop` into a hang-until-SIGKILL
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    signal.signal(signal.SIGTERM, _handler)
    return prev


def preemption_deadline(event: MaintenanceEvent,
                        now: Optional[float] = None) -> float:
    """Wall-clock deadline the grace window ends at."""
    return (now if now is not None else time.time()) + event.grace_s
