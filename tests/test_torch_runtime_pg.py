"""Twins of tests/test_placement_group.py for the port's runtime
(ray_tpu_torch): bundle placement by PACK, SPREAD, STRICT_PACK and
STRICT_SPREAD over the head and two accounting-only nodes, rollback,
leases routed to a bundle's node, tasks inside a group; and where the
port differs: a GPU bundle binds its node's GPUs, and an accounting-only
node may not count GPUs.

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

CLUSTER3 = {"num_cpus": 4}  # tests/test_placement_group.py's cluster3

CHECKS = {name: CLUSTER3 for name in (
    "pg_strict_spread_distinct_nodes", "pg_strict_spread_infeasible",
    "pg_strict_pack_single_node", "pg_strict_pack_infeasible",
    "pg_pack_prefers_fewest_nodes", "pg_pack_overflows_when_full",
    "pg_spread_round_robins", "pg_spread_overflow_is_best_effort",
    "pg_infeasible_rolls_back_cleanly", "pg_lease_routes_to_bundle_node",
    "pg_task_end_to_end", "port_accounting_node_refuses_gpu")}
# starts its own cluster and an agent with fake GPUs
CHECKS["port_pg_gpu_bundle_binds_its_gpu"] = None


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_placement_groups(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
