"""Twins of tests/test_actor.py for the port's runtime (ray_tpu_torch):
creation, ordering, errors, named actors, kill, exit, restart,
concurrency, async methods, handles in tasks, lease release.

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

C4 = {"num_cpus": 4}  # tests/test_actor.py's ray_start_regular

CHECKS = {name: C4 for name in (
    "actor_basic", "actor_ordering", "actor_method_exception",
    "actor_named", "actor_named_conflict", "actor_get_if_exists",
    "actor_init_failure", "actor_kill", "actor_exit", "actor_restart",
    "actor_max_concurrency", "actor_async", "actor_handle_passed_to_task",
    "actor_ordering_burst", "actor_graceful_exit_releases_resources")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_actor(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
