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

The worker's re-register loop runs here against a stub conductor and a
simulated clock: one failed call (the first on a connection a
restarted conductor dropped) does not end a worker whose re-register
period equals its orphan grace; an outage longer than the grace does.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import isolated
from ray_tpu_torch._private.worker_main import reregister_until_orphaned

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


class _Clock:
    def __init__(self):
        self.t = 0.0

    def sleep(self, s):
        self.t += s

    def __call__(self):
        return self.t


GRACE = 1.0  # the re-register period is 10 sleeps of 0.1 s: the grace


@pytest.mark.parametrize("case", ["one_failed_call", "outage",
                                  "written_off"])
def test_reregister_until_orphaned(case):
    """Each stub call takes 10 ms. `one_failed_call`: success, one
    failure, successes, then False: the loop ends only at the False.
    `outage`: every call after the first fails: the loop ends once the
    failures have lasted the grace, and within one retry of it.
    `written_off`: the first answer is False."""
    clock = _Clock()
    calls = []

    def register():
        clock.t += 0.01
        calls.append(clock.t)
        n = len(calls)
        if case == "written_off" or (case == "one_failed_call" and n == 8):
            return False
        if n == 2 or (case == "outage" and n > 1):
            raise ConnectionError("conductor unreachable")
        return True

    reregister_until_orphaned(register, GRACE, sleep=clock.sleep,
                              clock=clock)
    if case == "written_off":
        assert len(calls) == 1
    elif case == "one_failed_call":
        assert len(calls) == 8, calls
    else:
        lasted = clock.t - calls[1]
        assert GRACE < lasted <= GRACE + 0.11 + 1e-9, (lasted, calls)
