"""Resilience (port of the JAX package's resilience/): the failure-domain
tracker the conductor keeps, the preemption watcher of the node agent
and the head, gang supervision with the restart backoff and elastic
re-form of the trainer's workers mode, and the chaos harness (its plan
an argument, never an environment variable), with the serving plane's
monkey for `serve/disagg.py`'s replicas."""
from .chaos import (ChaosAction, ChaosError, ChaosMonkey, ChaosPlan,
                    ServeChaosMonkey, monkey_from_spec,
                    serve_monkey_from_spec)
from .domains import FailureDomainTracker
from .preemption import (MaintenanceEvent, PreemptionWatcher,
                         install_sigterm_notifier, read_maintenance_event)
from .supervisor import GangSupervisor, backoff_delay, elastic_reform

__all__ = ["ChaosAction", "ChaosError", "ChaosMonkey", "ChaosPlan",
           "FailureDomainTracker", "GangSupervisor", "MaintenanceEvent",
           "PreemptionWatcher", "ServeChaosMonkey", "backoff_delay",
           "elastic_reform", "install_sigterm_notifier", "monkey_from_spec",
           "read_maintenance_event", "serve_monkey_from_spec"]
