"""Twins of tests/test_conductor_restart.py for the port's runtime
(ray_tpu_torch): KV, a named actor, job metadata and a placement group
survive a conductor crash and restart on the same session directory;
and where the port differs: a GPU worker survives the crash and keeps
its GPU, so a second lease of it waits until the survivor is gone.

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

CHECKS = {name: {"num_cpus": 4} for name in (
    "restart_kv_and_named_actor_survive", "restart_job_metadata_survives",
    "restart_placement_group_survives",
    "port_restart_agent_node_actor_recharged",
    "port_restart_worker_before_its_node")}
CHECKS["port_restart_gpu_worker_keeps_its_gpu"] = None


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_restart(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
