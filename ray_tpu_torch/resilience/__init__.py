"""Resilience (port of the JAX package's resilience/): the trainer's
restart backoff, the failure-domain tracker the conductor keeps, and
the preemption watcher of the node agent and the head. Gang
supervision, elastic re-form and chaos wait for the trainer's workers
mode (ROADMAP Queue 1 item 3)."""
from .domains import FailureDomainTracker
from .preemption import (MaintenanceEvent, PreemptionWatcher,
                         install_sigterm_notifier, read_maintenance_event)
from .supervisor import backoff_delay

__all__ = ["FailureDomainTracker", "MaintenanceEvent", "PreemptionWatcher",
           "backoff_delay", "install_sigterm_notifier",
           "read_maintenance_event"]
