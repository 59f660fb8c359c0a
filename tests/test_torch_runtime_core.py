"""Twins of tests/test_core.py for the port's runtime (ray_tpu_torch):
put/get, tasks, refs as arguments, wait, timeouts, nested tasks,
resources, options, the store cap and blocked-lease release.

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

C4 = {"num_cpus": 4}  # tests/test_core.py's ray_start_regular

CHECKS = {name: C4 for name in (
    "core_put_get", "core_put_get_numpy_large", "core_simple_task",
    "core_task_with_ref_args", "core_task_large_result",
    "core_many_parallel_tasks", "core_task_exception_propagates",
    "core_num_returns", "core_wait", "core_wait_timeout_empty",
    "core_get_timeout", "core_nested_tasks",
    "core_task_passing_ref_between_tasks", "core_cluster_resources",
    "core_options_override", "core_reinit_error")}
# these start their own cluster, as their twins do
CHECKS["core_result_larger_than_store_cap"] = None
CHECKS["core_nested_get_releases_lease_no_deadlock"] = None


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_core(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
