"""Twins of tests/test_native_store.py and tests/test_object_plane.py for
the port's runtime (ray_tpu_torch): the C++ slab arena, spilling,
ranged reads and the cross-host chunked fetch.

Every check runs in a driver process of its own
(`ray_tpu_torch._private.isolated.run_checks`, hard timeout 200 s):
no cluster, worker or arena lives in the pytest process. The checks are
functions of `ray_tpu_torch/_private/runtime_checks.py`; each one is a
case here, and `__session_ended__` holds that every process of the run
had exited once its driver was done.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import isolated, runtime_checks

# the arena and store checks make their own (no cluster)
CHECKS = {name: None for name in (
    "native_alloc_write_read", "native_alignment",
    "native_exhaustion_returns_zero", "native_free_coalescing_and_reuse",
    "native_double_free_ignored", "native_random_stress",
    "native_cross_process_read", "native_odd_arena_size",
    "native_cleanup_leaked_segments",
    "object_plane_put_beyond_cap_all_readable",
    "object_plane_spill_restore_survives_reeviction",
    "object_plane_read_range_matches_stream",
    "object_plane_error_entries_not_spilled")}
CHECKS["native_delete_reclaims_arena_blocks"] = {"num_cpus": 1}
CHECKS["native_store_integration_uses_arena"] = {"num_cpus": 2}
CHECKS["object_plane_cross_host_chunked_fetch"] = \
    runtime_checks.FORCED_REMOTE
CHECKS["object_plane_cross_host_small_inline"] = runtime_checks.FORCED_REMOTE


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_store(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
