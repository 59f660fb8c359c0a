"""Twins of tests/test_log_monitor.py and test_memory_monitor.py for
the port's runtime (ray_tpu_torch): the log tailer (incremental,
partial lines, truncation, the per-tick cap), worker prints mirrored to
the driver's stderr and the `log_to_driver` flag; the memory monitor's
threshold, victim choice and readers, and its OOM kills surfacing as
OutOfMemoryError.

Every check runs in a driver process of its own
(`ray_tpu_torch._private.isolated.run_checks`, hard timeout 200 s):
no cluster, agent, head or worker lives in the pytest process. The
checks are functions of `ray_tpu_torch/_private/cluster_checks.py`;
each one is a case here, and `__session_ended__` holds that every
process of the run had exited once its driver was done.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import cluster_checks as cc
from ray_tpu_torch._private import isolated

C2 = {"num_cpus": 2}

CHECKS = {
    "log_tailer_incremental_and_partial_lines": None,
    "log_tailer_survives_truncation": None,
    "log_format_prefix": None,
    "log_worker_prints_reach_driver": C2,
    "log_to_driver_disabled": {"num_cpus": 2,
                               "_system_config": {"log_to_driver": 0}},
    "log_burst_beyond_tick_cap_is_retained": None,
    "mem_threshold_logic": None,
    "mem_victim_prefers_busy_then_rss": None,
    "mem_real_readers_sane": None,
    "mem_oom_kill_surfaces_typed_error": cc.OOM,
    "mem_oom_retries_then_fails_typed": cc.OOM,
}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_monitors(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
