"""Twins of tests/test_fork_server.py and tests/test_config.py for the
port's runtime (ray_tpu_torch): worker handles, the fork template, the
cached-lease crash retry, and the flag table, which the port sets only
through init(_system_config=).

Every check runs in a driver process of its own
(`ray_tpu_torch._private.isolated.run_checks`, hard timeout 200 s):
no cluster, worker or arena lives in the pytest process. The checks are
functions of `ray_tpu_torch/_private/runtime_checks.py`; each one is a
case here, and `__session_ended__` holds that every process of the run
had exited once its driver was done.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import isolated

CHECKS = {
    "fork_forked_proc_liveness_and_signals": None,
    "fork_forked_proc_wait_timeout": None,
    "fork_cluster_uses_fork_server_and_workers_die_fast": {"num_cpus": 4},
    "fork_cached_lease_survives_worker_crash": None,
    "config_defaults_and_system_config_resolution": None,
    "config_unknown_flag_rejected": None,
    "config_apply_exports_nothing": None,
    "config_describe_lists_all_flags": None,
    "config_system_config_reaches_the_runtime": None,
    "config_system_config_restored_on_shutdown": None,
}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_spawn(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
