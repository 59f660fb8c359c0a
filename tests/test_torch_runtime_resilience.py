"""Twins of the cluster layer's cases of tests/test_resilience.py for
the port's runtime (ray_tpu_torch): the failure-domain tracker (decay,
exemption, drains, operator quarantine), the maintenance-event channel,
and the conductor's preemption drain and quarantine over leases and
bundles. The trainer's cases wait for the trainer's workers mode
(ROADMAP Queue 1 item 3). And where the port differs: the
maintenance-event file is the node agent's argument, never an
environment variable.

Every check runs in a driver process of its own
(`ray_tpu_torch._private.isolated.run_checks`, hard timeout 200 s):
no cluster, agent, head or worker lives in the pytest process. The
checks are functions of `ray_tpu_torch/_private/cluster_checks.py`;
each one is a case here, and `__session_ended__` holds that every
process of the run had exited once its driver was done.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import isolated

CHECKS = {name: None for name in (
    "res_tracker_threshold_decay_and_exempt",
    "res_tracker_drain_and_manual_quarantine",
    "res_maintenance_event_channel",
    "res_conductor_preemption_drains_and_expires",
    "res_conductor_quarantine_excludes_from_leases_and_bundles")}
CHECKS["port_agent_maintenance_event_argument"] = {
    "num_cpus": 1, "_system_config": {"maintenance_poll_s": 0.05}}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_resilience(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
