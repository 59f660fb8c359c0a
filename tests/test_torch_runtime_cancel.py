"""Twins of tests/test_cancel.py and tests/test_refcount.py for the port's
runtime (ray_tpu_torch): cooperative and forced cancels, queued actor
calls, borrowed refs; owner counts, borrowers and frees.

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

C4 = {"num_cpus": 4}  # tests/test_cancel.py's cluster fixture
C2 = {"num_cpus": 2}  # tests/test_refcount.py's cluster fixture

CHECKS = {name: C4 for name in (
    "cancel_sleeping_task_returns_fast", "cancel_force_kills_worker",
    "cancel_interrupts_python_loop", "cancel_before_execution",
    "cancel_actor_survives_cancel_of_queued_call",
    "cancel_completed_task_is_noop", "cancel_force_on_actor_call_rejected",
    "cancel_one_of_multi_return_delivers_siblings",
    "cancel_borrowed_ref_forwards_to_owner",
    "cancel_borrowed_dep_wait_releases_submit_slots")}
CHECKS.update({name: C2 for name in (
    "refcount_put_loop_holds_store_flat",
    "refcount_task_result_freed_on_drop",
    "refcount_result_dropped_while_pending_is_freed",
    "refcount_borrowed_ref_survives_lender_death",
    "refcount_live_handle_never_freed")})


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_cancel(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
