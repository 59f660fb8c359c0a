"""Twins of tests/test_cli_jobs.py and test_remote_driver.py for the
port's runtime (ray_tpu_torch): a standalone head (`python -m
ray_tpu_torch start --head`), drivers connecting to it, the `status`,
`list`, `job` and `stop` commands, jobs that succeed, fail and are
stopped; and where the port differs: `shutdown_cluster` refused in a
driver that hosts the conductor, and the job wiring variables
(RTT_ADDRESS, RTT_JOB_ID).

Every check runs in a driver process of its own
(`ray_tpu_torch._private.isolated.run_checks`, hard timeout 240 s):
no cluster, agent, head or worker lives in the pytest process. The
checks are functions of `ray_tpu_torch/_private/cluster_checks.py`;
each one is a case here, and `__session_ended__` holds that every
process of the run had exited once its driver was done.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import isolated

CHECKS = {name: None for name in (
    "cli_connect_to_standalone_head", "cli_status_and_list",
    "cli_job_submit_and_logs", "cli_job_failure_status", "cli_job_stop",
    "cli_job_roundtrip", "remote_external_driver_runs_tasks_and_actors",
    "remote_two_drivers_share_named_actors", "port_job_wiring_variables",
    "port_standalone_head_flags_and_maintenance_event")}
CHECKS["port_shutdown_cluster_refused_in_driver"] = {"num_cpus": 2}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=240.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_jobs(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
