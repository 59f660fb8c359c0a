"""Twins of tests/test_multinode.py for the port's runtime
(ray_tpu_torch): node agents joining a 1-CPU head, tasks and actors
placed on them, a dead actor and a silent agent detected, SPREAD, data
locality, node affinity, and two drivers forming one torch.distributed
gloo job through the conductor's KV (the twin of
test_two_process_jax_distributed). `test_serve_proxy_on_every_node` has
no twin: it needs `serve/` (ROADMAP Queue 1 item 8). And where the port
differs: each node's own GPU ids under fake CUDA_VISIBLE_DEVICES lists,
a dead node's written-off GPU worker exiting before its GPU is leased
again, the agent taking the head's flags, a failed agent spawn failing
its lease.

Every check runs in a driver process of its own
(`ray_tpu_torch._private.isolated.run_checks`, hard timeout 240 s):
no cluster, agent, head or worker lives in the pytest process. The
checks are functions of `ray_tpu_torch/_private/cluster_checks.py`;
each one is a case here, and `__session_ended__` holds that every
process of the run had exited once its driver was done.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import cluster_checks as cc
from ray_tpu_torch._private import isolated

SMALL_HEAD = {"num_cpus": 1, "_system_config": cc.FAST}

CHECKS = {name: SMALL_HEAD for name in (
    "mn_agent_registers_resources", "mn_task_placed_on_agent_node",
    "mn_actor_on_agent_node_death_detected",
    "mn_dead_agent_detected_by_heartbeat_expiry",
    "mn_two_process_torch_distributed", "mn_spread_scheduling_strategy",
    "mn_locality_aware_leasing", "mn_node_affinity_strategies",
    "port_failed_agent_spawn_fails_lease")}
# these start their own cluster and agent processes
for _name in ("port_gpu_ids_per_node",
              "port_dead_node_worker_written_off_exits",
              "port_agent_takes_head_flags"):
    CHECKS[_name] = None


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=240.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_multinode(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
