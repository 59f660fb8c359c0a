"""The cluster layer's checks, run by `isolated.run_checks` in a driver
process of their own, as `runtime_checks.py`'s are (tests/
test_torch_runtime_{pg,multinode,restart,monitors,jobs,resilience}.py
make each one a test case).

Most are twins of the JAX package's tests of the same layer
(tests/test_placement_group.py, test_multinode.py,
test_conductor_restart.py, test_log_monitor.py, test_memory_monitor.py,
test_cli_jobs.py, test_remote_driver.py, test_resilience.py), one
function per case, named after its file and case. The `port_*` ones
check where the port differs: GPUs per node under fake visible lists, a
GPU lease inside a bundle, the accounting-only node's GPU refusal, a
dead node's written-off worker, a GPU worker and an agent node's actor
surviving a conductor restart, the agent taking the head's flags, a
failed agent spawn, `shutdown_cluster` in a driver, the job wiring
variables, and the maintenance-event file and flags as arguments.

Agents and heads that a check starts run as `python -m ray_tpu_torch
start ...` with RTT_SESSION_DIR under the run's directory (inherited
from the isolated driver) and, for a head, TMPDIR there too, so the
harness finds and ends every process they leave. No GPU is touched:
"GPUs" are counts (`--num-gpus`) with fake CUDA_VISIBLE_DEVICES lists.
This module imports no torch at the top: the fork template must not.
"""
from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions as exc

from .ids import NodeID
from .runtime_checks import _raises, _worker
from .worker_spawn import _repo_env, pid_exited

# short timings for every check's cluster: a silent agent is dead after
# NODE_TIMEOUT, an agent heartbeats every HEARTBEAT
NODE_TIMEOUT = 2.0
HEARTBEAT = 0.3
FAST = {"node_timeout": NODE_TIMEOUT, "node_heartbeat": HEARTBEAT}
# a written-off worker exits on the conductor's shutdown notice, at the
# latest on its next re-register (every 2 s under the harness's
# worker_orphan_grace of 2 s), plus the RPC
ORPHAN_EXIT_BOUND_S = 3.0


def _conductor():
    return _worker().conductor


def _wait_until(pred, timeout=15.0, msg="condition not reached"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() >= deadline:
            raise AssertionError(msg() if callable(msg) else msg)
        time.sleep(0.05)


def _child_env(**extra) -> dict:
    env = dict(os.environ)
    _repo_env(env)
    env.update({k: v for k, v in extra.items() if v is not None})
    return env


def start_agent(num_cpus: float = 2, num_gpus: int = 0,
                visible: str = None, resources: dict = None,
                node_id: str = None, timeout: float = 60.0):
    """`python -m ray_tpu_torch start --address ...` joined to the
    current cluster; returns (Popen, node_id) once it is registered."""
    node_id = node_id or NodeID().hex()
    host, port = _worker().conductor_address
    cmd = [sys.executable, "-m", "ray_tpu_torch", "start", "--address",
           f"{host}:{port}", "--num-cpus", str(num_cpus), "--num-gpus",
           str(num_gpus), "--node-id", node_id]
    if resources:
        cmd += ["--resources", json.dumps(resources)]
    log = open(os.path.join(_worker().session_dir,
                            f"agent-{node_id[:12]}.log"), "ab")
    proc = subprocess.Popen(cmd, env=_child_env(CUDA_VISIBLE_DEVICES=visible),
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    _wait_until(lambda: any(n["node_id"] == node_id and n["alive"]
                            for n in rt.nodes()), timeout,
                f"agent {node_id[:12]} never registered")
    return proc, node_id


def _end(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=10)


@rt.remote
class Where:
    """Where a worker runs: its node, GPUs and parent."""

    def where(self):
        from ray_tpu_torch._private.worker_spawn import (ENV_GPU_INDICES,
                                                         ENV_NODE_ID)

        return {"node": os.environ.get(ENV_NODE_ID),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "indices": os.environ.get(ENV_GPU_INDICES),
                "pid": os.getpid(), "ppid": os.getppid()}


@rt.remote
def where_task():
    from ray_tpu_torch._private.worker_spawn import ENV_NODE_ID

    return (os.environ.get(ENV_NODE_ID),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


# ---------------------------------------------------------- placement groups
# twins of tests/test_placement_group.py: the head (4 CPUs) and two
# accounting-only nodes of 4 CPUs each

def _cluster3():
    for nid in ("nodeA", "nodeB"):
        _conductor().call("register_node", nid, {"CPU": 4.0}, None,
                          timeout=10.0)
    return _worker()


def _pg_info(pg):
    for rec in _conductor().call("list_placement_groups", timeout=10.0):
        if rec["pg_id"] == pg.id:
            return rec
    raise AssertionError("pg not found")


def _node_avail():
    return {n["node_id"]: n["available"]
            for n in _conductor().call("nodes", timeout=10.0)}


def pg_strict_spread_distinct_nodes():
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 2}] * 3, strategy="STRICT_SPREAD")
    info = _pg_info(pg)
    assert len(set(info["assignments"])) == 3
    avail = _node_avail()
    for nid in info["assignments"]:
        assert avail[nid]["CPU"] == 2.0
    remove_placement_group(pg)
    assert all(a["CPU"] == 4.0 for a in _node_avail().values())


def pg_strict_spread_infeasible():
    from ray_tpu_torch.util.placement_group import placement_group

    _cluster3()
    e = _raises(Exception, placement_group, [{"CPU": 1}] * 4,
                strategy="STRICT_SPREAD")
    assert "STRICT_SPREAD" in str(e), e


def pg_strict_pack_single_node():
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_PACK")
    assert len(set(_pg_info(pg)["assignments"])) == 1
    remove_placement_group(pg)


def pg_strict_pack_infeasible():
    from ray_tpu_torch.util.placement_group import placement_group

    _cluster3()
    # 6 CPUs fit the cluster but no single 4-CPU node
    e = _raises(Exception, placement_group, [{"CPU": 3}, {"CPU": 3}],
                strategy="STRICT_PACK")
    assert "STRICT_PACK" in str(e), e


def pg_pack_prefers_fewest_nodes():
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
    assert len(set(_pg_info(pg)["assignments"])) == 1
    remove_placement_group(pg)


def pg_pack_overflows_when_full():
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 3}, {"CPU": 3}], strategy="PACK")
    assert len(set(_pg_info(pg)["assignments"])) == 2
    remove_placement_group(pg)


def pg_spread_round_robins():
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 1}] * 3, strategy="SPREAD")
    assert len(set(_pg_info(pg)["assignments"])) == 3
    remove_placement_group(pg)


def pg_spread_overflow_is_best_effort():
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 1}] * 5, strategy="SPREAD")
    info = _pg_info(pg)
    assert len(info["assignments"]) == 5
    assert len(set(info["assignments"])) == 3
    remove_placement_group(pg)


def pg_infeasible_rolls_back_cleanly():
    from ray_tpu_torch.util.placement_group import placement_group

    _cluster3()
    before = _node_avail()
    _raises(Exception, placement_group,
            [{"CPU": 4}, {"CPU": 4}, {"CPU": 4}, {"CPU": 1}],
            strategy="PACK")
    assert _node_avail() == before


def pg_lease_routes_to_bundle_node():
    """A lease inside the group charges the node holding the bundle —
    the synthetic _pg_ keys only exist there."""
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 2}], strategy="SPREAD")
    target = _pg_info(pg)["assignments"][0]
    c = _conductor()
    worker_id, _ = c.call("lease_worker", {"CPU": 2.0}, pg.id, timeout=60.0)
    assert _node_avail()[target][f"_pg_{pg.id}_CPU"] == 0.0
    c.call("return_worker", worker_id, timeout=10.0)
    assert _node_avail()[target][f"_pg_{pg.id}_CPU"] == 2.0
    remove_placement_group(pg)


def pg_task_end_to_end():
    """Tasks scheduled into a group run (the head's pool serves the
    accounting nodes)."""
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    _cluster3()
    pg = placement_group([{"CPU": 1}] * 2, strategy="SPREAD")

    @rt.remote
    def f(x):
        return x * 2

    out = rt.get([f.options(num_cpus=1, placement_group=pg).remote(i)
                  for i in range(4)], timeout=120.0)
    assert out == [0, 2, 4, 6]
    remove_placement_group(pg)


# ------------------------------------------------------------------ GPUs

def _set_visible(spec):
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = spec
    return old


def _restore_visible(old):
    if old is None:
        os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = old


def port_gpu_ids_per_node():
    """Each node counts and names its own GPUs: a head whose driver sees
    CUDA_VISIBLE_DEVICES=3,5 and an agent started under 6,8, two GPUs
    each. Four GPU actors are bound to 3, 5, 6 and 8, each on the node
    that owns the id (the agent's as children of the agent, spawned
    cold), and a host worker of the agent sees no GPU."""
    old = _set_visible("3,5")
    agent = None
    try:
        rt.init(num_cpus=2, resources={"GPU": 2}, _system_config=FAST)
        agent, agent_id = start_agent(num_cpus=2, num_gpus=2, visible="6,8")
        head_id = next(n["node_id"] for n in rt.nodes() if n["head"])
        by_node = {n["node_id"]: n["gpu_ids"] for n in rt.nodes()}
        assert by_node == {head_id: ["3", "5"], agent_id: ["6", "8"]}, \
            by_node
        assert rt.cluster_resources()["GPU"] == 4.0
        actors = [Where.options(num_gpus=1).remote() for _ in range(4)]
        got = rt.get([a.where.remote() for a in actors], timeout=120.0)
        assert sorted(g["visible"] for g in got) == ["3", "5", "6", "8"], got
        for g in got:
            owner = head_id if g["visible"] in ("3", "5") else agent_id
            assert g["node"] == owner, g
            assert g["ppid"] == (agent.pid if owner == agent_id
                                 else os.getpid()), g
        assert rt.available_resources()["GPU"] == 0.0
        from ray_tpu_torch.util.scheduling_strategies import \
            NodeAffinitySchedulingStrategy

        pinned = where_task.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(agent_id))
        assert rt.get(pinned.remote(), timeout=60.0) == (agent_id, "")
    finally:
        _restore_visible(old)
        if agent is not None:
            rt.shutdown()
            _end(agent)


def port_pg_gpu_bundle_binds_its_gpu():
    """A GPU lease inside a placement group asks for "_pg_<id>_GPU" and
    binds that many of the bundle node's GPUs: with the head holding
    none, a STRICT_PACK group of two one-GPU bundles lands on an agent
    started under CUDA_VISIBLE_DEVICES=6,8, and an actor and a task in
    it get "6" and "8"."""
    from ray_tpu_torch._private.conductor import _gpus_needed
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    assert _gpus_needed({"_pg_x_GPU": 1.0, "_pg_x_CPU": 0.0}) == 1
    assert _gpus_needed({"GPU": 2.0}) == 2
    assert _gpus_needed({"_pg_x_GPU": 0.5}) == 0
    # a user's own resource named like a card binds none
    assert _gpus_needed({"A100_GPU": 1.0}) == 0
    assert _gpus_needed({"_pg_x_A100_GPU": 1.0}) == 0
    rt.init(num_cpus=2, resources={"GPU": 0}, _system_config=FAST)
    agent, agent_id = start_agent(num_cpus=2, num_gpus=2, visible="6,8")
    try:
        pg = placement_group([{"GPU": 1, "CPU": 1}] * 2,
                             strategy="STRICT_PACK")
        assert pg.wait(30.0)
        assert _pg_info(pg)["assignments"] == [agent_id, agent_id]
        avail = rt.available_resources()
        assert avail["GPU"] == 0.0 and avail[f"_pg_{pg.id}_GPU"] == 2.0, \
            avail
        a = Where.options(num_gpus=1, placement_group=pg).remote()
        wa = rt.get(a.where.remote(), timeout=60.0)

        @rt.remote(num_gpus=1)
        def gpu_task():
            return os.environ["CUDA_VISIBLE_DEVICES"]

        wt = rt.get(gpu_task.options(placement_group=pg).remote(),
                    timeout=60.0)
        assert wa["node"] == agent_id and {wa["visible"], wt} == {"6", "8"}, \
            (wa, wt)
        # the task's lease goes back (after the submitter's reuse TTL);
        # the actor's stays
        _wait_until(lambda: rt.available_resources()[f"_pg_{pg.id}_GPU"]
                    == 1.0, msg="the task's GPU lease never came back")
        rt.kill(a)
        _wait_until(lambda: rt.available_resources()[f"_pg_{pg.id}_GPU"]
                    == 2.0, msg="the bundle's GPU never came back")
        remove_placement_group(pg)
        _wait_until(lambda: rt.available_resources()["GPU"] == 2.0,
                    msg="the group's GPUs never went back to the node")
    finally:
        rt.shutdown()
        _end(agent)


def port_accounting_node_refuses_gpu():
    """An accounting-only node (no agent) has no process that could own
    a card: registering one with GPUs raises, and the cluster is
    unchanged."""
    from ray_tpu_torch._private.rpc import RemoteError

    before = rt.cluster_resources()
    e = _raises(RemoteError, _conductor().call, "register_node", "acct",
                {"CPU": 1.0, "GPU": 1.0}, None, timeout=10.0)
    assert isinstance(e.cause, ValueError), e
    assert "accounting-only" in str(e.cause), e
    _conductor().call("register_node", "acct", {"CPU": 1.0, "GPU": 0.0},
                      None, timeout=10.0)
    assert rt.cluster_resources()["GPU"] == before["GPU"]
    assert rt.cluster_resources()["CPU"] == before["CPU"] + 1.0


def port_dead_node_worker_written_off_exits():
    """An agent SIGKILLed under its GPU actor: within node_timeout + 2 s
    the node is dead and its GPU leaves the cluster; the orphaned GPU
    worker, written off, exits within ORPHAN_EXIT_BOUND_S of that, and
    were it to re-register it would be refused; a call on the actor
    raises ActorDiedError. Only then does a second agent with the same
    GPU id join, and a GPU actor on it gets the GPU."""
    rt.init(num_cpus=1, resources={"GPU": 0}, _system_config=FAST)
    agent, agent_id = start_agent(num_cpus=2, num_gpus=1, visible="4")
    second = None
    try:
        a = Where.options(num_gpus=1, max_restarts=0).remote()
        wa = rt.get(a.where.remote(), timeout=60.0)
        assert (wa["node"], wa["visible"], wa["ppid"]) == \
            (agent_id, "4", agent.pid), wa
        worker = next(w for w in _conductor().call("list_workers",
                                                   timeout=10.0)
                      if w["pid"] == wa["pid"])
        t0 = time.monotonic()
        agent.kill()
        agent.wait(timeout=10)
        _wait_until(lambda: not any(n["alive"] for n in rt.nodes()
                                    if n["node_id"] == agent_id),
                    NODE_TIMEOUT + 2.0, "the dead node was never detected")
        detected = time.monotonic()
        assert detected - t0 <= NODE_TIMEOUT + 2.0
        assert rt.cluster_resources().get("GPU", 0) == 0
        _wait_until(lambda: pid_exited(wa["pid"]), ORPHAN_EXIT_BOUND_S,
                    "the orphaned GPU worker did not exit")
        ok = _conductor().call("register_worker", worker["worker_id"],
                               tuple(worker["address"]), wa["pid"],
                               agent_id, (0,), timeout=10.0)
        assert ok is False
        _raises(exc.ActorDiedError, rt.get, a.where.remote(), timeout=30.0)
        second, second_id = start_agent(num_cpus=2, num_gpus=1,
                                        visible="4")
        b = Where.options(num_gpus=1).remote()
        wb = rt.get(b.where.remote(), timeout=60.0)
        assert (wb["node"], wb["visible"]) == (second_id, "4"), wb
    finally:
        rt.shutdown()
        _end(agent)
        if second is not None:
            _end(second)


def port_agent_takes_head_flags():
    """Flags set on the head hold in a joining agent (from
    session_info) and in its workers (through the spawn): the
    heartbeat period and the memory monitor's threshold."""
    from ray_tpu_torch._private.rpc import RpcClient
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    want = {"node_heartbeat": 0.25, "memory_usage_threshold": 0.99,
            "node_timeout": 3.0}
    rt.init(num_cpus=1, resources={"GPU": 0}, _system_config=want)
    agent, agent_id = start_agent(num_cpus=2, num_gpus=1, visible="9")
    try:
        node = next(n for n in rt.nodes() if n["node_id"] == agent_id)
        c = RpcClient(tuple(node["address"]))
        try:
            snap = c.call("config_snapshot", timeout=10.0)
        finally:
            c.close()
        for k, v in want.items():
            assert snap.get(k) == v, (k, snap)

        @rt.remote
        def flags():
            from ray_tpu_torch._private.config import config

            return {k: config.get(k) for k in want}

        pinned = flags.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(agent_id)))
        # a forked host worker and a cold-started GPU worker
        for opts in ({}, {"num_gpus": 1}):
            got = rt.get(pinned.options(**opts).remote(), timeout=60.0)
            assert got == want, (opts, got)
    finally:
        rt.shutdown()
        _end(agent)


def port_failed_agent_spawn_fails_lease():
    """An agent that cannot spawn fails the lease waiting for it — a
    task raises SchedulingError, a GPU actor dies with the agent's
    error — and nothing falls back to a worker of another node."""
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent(_worker().conductor_address,
                      {"CPU": 2.0, "GPU": 1.0, "widget": 1.0},
                      gpu_ids=["2"]).start()
    try:
        def refuse(worker_id, gpus=None):
            raise OSError("no room for a worker")

        agent.handler.spawn_worker = refuse

        @rt.remote(resources={"widget": 1.0}, max_retries=0)
        def needs_widget():
            return "ran"

        e = _raises(exc.SchedulingError, rt.get, needs_widget.remote(),
                    timeout=60.0)
        assert "no room for a worker" in str(e), e
        e = _raises(exc.ActorDiedError, Where.options(num_gpus=1).remote)
        assert "no room for a worker" in str(e), e
        assert rt.available_resources()["widget"] == 1.0
    finally:
        agent.stop()


# ------------------------------------------------------------ multi-node
# twins of tests/test_multinode.py: a 1-CPU head, so anything bigger must
# land on an agent node

def mn_agent_registers_resources():
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent(_worker().conductor_address,
                      {"CPU": 4.0, "widget": 2.0}).start()
    try:
        total = rt.cluster_resources()
        assert total["CPU"] == 5.0 and total["widget"] == 2.0, total
        assert any(n["node_id"] == agent.node_id and n["alive"]
                   for n in rt.nodes())
    finally:
        agent.stop()
    total = rt.cluster_resources()
    assert total["CPU"] == 1.0 and "widget" not in total, total


def mn_task_placed_on_agent_node():
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    try:
        node, _ = rt.get(where_task.options(num_cpus=2).remote(),
                         timeout=60.0)
        assert node == agent.node_id
        assert agent.handler._procs, "agent spawned no worker"
    finally:
        agent.stop()


def mn_actor_on_agent_node_death_detected():
    """A remote node's actor process killed: the agent's heartbeat
    reports the death and callers get ActorDiedError."""
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    try:
        a = Where.options(num_cpus=2, max_restarts=0).remote()
        pid = rt.get(a.where.remote(), timeout=60.0)["pid"]
        os.kill(pid, signal.SIGKILL)

        def calls():
            for _ in range(100):  # the death arrives by heartbeat
                rt.get(a.where.remote(), timeout=30.0)
                time.sleep(0.1)

        _raises(exc.ActorDiedError, calls)
    finally:
        agent.stop()


def mn_dead_agent_detected_by_heartbeat_expiry():
    """An agent that stops heartbeating (host crash) is marked dead and
    its resources leave the pool."""
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    assert rt.cluster_resources()["CPU"] == 5.0
    # a host crash: stop the heartbeat and the RPC server, no deregister
    agent._stopped.set()
    agent.server.stop()
    _wait_until(lambda: rt.cluster_resources().get("CPU") == 1.0, 15.0,
                "dead agent's resources never reclaimed")


_CHILD = r"""
import os, sys
import torch
import torch.distributed as dist

import ray_tpu_torch as rt
from ray_tpu_torch.parallel.distributed import initialize_torch_distributed

rank = int(sys.argv[1])
rt.init(address=sys.argv[2])
c = rt._private.worker.global_worker.conductor
initialize_torch_distributed(
    "test_gang", rank, 2,
    kv_put=lambda k, v, namespace: c.call("kv_put", k, v, True, namespace,
                                          timeout=10.0),
    kv_get=lambda k, namespace: c.call("kv_get", k, namespace, timeout=10.0),
    host="127.0.0.1", device="cpu", timeout=60.0)
assert dist.get_world_size() == 2
x = torch.tensor([float(rank) + 1.0])
dist.all_reduce(x)
print("MULTIHOST_OK", float(x), flush=True)
dist.destroy_process_group()
rt.shutdown()
"""


def mn_two_process_torch_distributed():
    """Two driver processes rendezvous through the conductor KV into ONE
    torch.distributed job (gloo on the CPU): an all_reduce of each
    rank's rank + 1 gives 3.0 on both (the twin of
    test_two_process_jax_distributed)."""
    host, port = _worker().conductor_address
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(rank), f"{host}:{port}"],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "MULTIHOST_OK 3.0" in out, f"rank {rank} output:\n{out}"


def mn_spread_scheduling_strategy():
    """SPREAD prefers the emptiest node; DEFAULT packs head-first."""
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    try:
        @rt.remote(num_cpus=1, scheduling_strategy="SPREAD")
        def where():
            time.sleep(0.8)  # keep leases overlapping
            return os.environ.get("RTT_NODE_ID")

        nodes = set(rt.get([where.remote() for _ in range(4)],
                           timeout=60.0))
        assert len(nodes) == 2, f"SPREAD used only {nodes}"
        head_nodes = {rt.get(where_task.remote(), timeout=60.0)[0]
                      for _ in range(3)}
        assert agent.node_id not in head_nodes
    finally:
        agent.stop()


def mn_locality_aware_leasing():
    """A task whose large, locator-only argument lives on the agent node
    leases there though the head has room too."""
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    try:
        @rt.remote(num_cpus=2)  # the head has 1 CPU: runs on the agent
        def big():
            return np.zeros(16 << 20, np.uint8)  # stays with its holder

        ref = big.remote()
        rt.wait([ref], timeout=60.0)

        @rt.remote(num_cpus=1)  # fits the head too
        def consume(a):
            return os.environ.get("RTT_NODE_ID"), a.nbytes

        node, nbytes = rt.get(consume.remote(ref), timeout=60.0)
        assert nbytes == 16 << 20
        assert node == agent.node_id, \
            f"consumer ran on {node}, arg lives on {agent.node_id}"
    finally:
        agent.stop()


def mn_node_affinity_strategies():
    """Hard affinity pins (or fails for unknown nodes), soft degrades."""
    from ray_tpu_torch._private.node_agent import NodeAgent
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy as Affinity

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    try:
        pinned = where_task.options(
            scheduling_strategy=Affinity(agent.node_id, soft=False))
        assert rt.get(pinned.remote(), timeout=60.0)[0] == agent.node_id
        _raises(exc.SchedulingError, rt.get, where_task.options(
            scheduling_strategy=Affinity("no-such-node", soft=False)
        ).remote(), timeout=30.0)
        soft = where_task.options(
            scheduling_strategy=Affinity("no-such-node", soft=True))
        assert rt.get(soft.remote(), timeout=60.0)[0] is not None
        a = Where.options(num_cpus=1, scheduling_strategy=Affinity(
            agent.node_id, soft=False)).remote()
        assert rt.get(a.where.remote(), timeout=60.0)["node"] == \
            agent.node_id
        rt.kill(a)
    finally:
        agent.stop()


# ------------------------------------------------------ conductor restart
# twins of tests/test_conductor_restart.py: the conductor "crashes" (its
# RPC server and monitor stop, its workers live on) and a new one starts
# on the same session directory and port

def _crash_and_restart(resources, **kwargs):
    from ray_tpu_torch._private.conductor import Conductor
    from ray_tpu_torch._private.rpc import ConnectionLost

    old = rt._conductor
    old.handler._stopped = True
    old.server.stop()
    host, port = old.address
    new = Conductor(resources, old.handler._session_dir, host=host,
                    port=port, **kwargs).start()
    # the driver's client re-dials on its next call, but a call sent
    # before it has seen the old connection drop raises ConnectionLost
    # (recovery is the caller's retry): one idempotent call, retried, so
    # the check's own calls go to the new conductor
    deadline = time.monotonic() + 10.0
    while True:
        try:
            _worker().conductor.call("kv_get", b"__restart_probe__",
                                     "default", timeout=5.0)
            return new
        except ConnectionLost:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def _wait_snapshot():
    """Until the monitor has flushed every change so far (it clears the
    dirty mark, then writes the file)."""
    path = os.path.join(_worker().session_dir, "conductor_state.pkl")
    handler = rt._conductor.handler
    _wait_until(lambda: os.path.exists(path) and not handler._dirty, 10.0,
                "no snapshot written")
    time.sleep(0.5)


@rt.remote
class Survivor:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n, os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


def restart_kv_and_named_actor_survive():
    w = _worker()
    c = Survivor.options(name="survivor").remote()
    assert rt.get(c.inc.remote(), timeout=60.0)[0] == 1
    w.conductor.call("kv_put", b"k", b"v-before-crash", True, "default",
                     timeout=5.0)
    _wait_snapshot()
    new = _crash_and_restart({"CPU": 4.0})
    try:
        assert w.conductor.call("kv_get", b"k", "default",
                                timeout=10.0) == b"v-before-crash"
        h = rt.get_actor("survivor")
        assert rt.get(h.inc.remote(), timeout=60.0)[0] == 2
        # the surviving worker re-announces itself
        _wait_until(lambda: any(
            wk["pid"] is not None and wk["state"] == "ACTOR"
            for wk in new.handler.list_workers()), 20.0,
            "actor worker never re-registered")
    finally:
        new.stop()


def restart_job_metadata_survives():
    w = _worker()
    job_id = w.conductor.call("submit_job", "echo done", None, None, None,
                              {"who": "test"}, timeout=30.0)
    _wait_until(lambda: w.conductor.call("get_job", job_id, timeout=5.0)[
        "status"] == "SUCCEEDED", 30.0, "job never succeeded")
    _wait_snapshot()
    new = _crash_and_restart({"CPU": 4.0})
    try:
        rec = w.conductor.call("get_job", job_id, timeout=10.0)
        assert rec["status"] == "SUCCEEDED"
        assert rec["metadata"] == {"who": "test"}
    finally:
        new.stop()


def restart_placement_group_survives():
    from ray_tpu_torch.util.placement_group import placement_group

    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=30.0)
    _wait_snapshot()
    new = _crash_and_restart({"CPU": 4.0})
    try:
        assert _conductor().call("placement_group_ready", pg.id,
                                 timeout=10.0)

        @rt.remote(num_cpus=2)
        def inside():
            return "ok"

        assert rt.get(inside.options(placement_group=pg).remote(),
                      timeout=60.0) == "ok"
    finally:
        new.stop()


def port_restart_agent_node_actor_recharged():
    """An actor on an agent node survives a conductor restart: its
    agent registers again (its heartbeat is refused by the new
    conductor), the actor's lease is charged on that node once it does,
    the actor answers, and killing it gives the node its CPUs back."""
    from ray_tpu_torch._private.node_agent import NodeAgent

    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    new = None
    try:
        s = Survivor.options(
            num_cpus=2, name="remote-survivor",
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                agent.node_id)).remote()
        assert rt.get(s.inc.remote(), timeout=60.0)[0] == 1
        _wait_snapshot()
        new = _crash_and_restart({"CPU": 4.0})

        def agent_cpus():
            n = [n for n in rt.nodes() if n["node_id"] == agent.node_id]
            return n[0]["available"]["CPU"] if n else None

        _wait_until(lambda: agent_cpus() == 2.0, 20.0,
                    lambda: f"the actor's lease not charged again: "
                    f"{agent_cpus()}")
        h = rt.get_actor("remote-survivor")
        assert rt.get(h.inc.remote(), timeout=60.0)[0] == 2
        rt.kill(h)
        _wait_until(lambda: agent_cpus() == 4.0, 20.0,
                    "the agent's CPUs never came back")
    finally:
        agent.stop()
        if new is not None:
            new.stop()


def port_restart_worker_before_its_node():
    """After a conductor restart an agent node's actor worker may
    re-register before its agent does: it is kept (its node may come
    back within restore_grace), and once the agent registers again its
    lease is charged there and the actor answers."""
    from ray_tpu_torch._private import node_agent
    from ray_tpu_torch._private.node_agent import NodeAgent

    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    period = node_agent._heartbeat_period
    parked = threading.Event()
    resume = threading.Event()

    def park() -> float:
        parked.set()
        resume.wait(60.0)
        return 0.0

    agent = NodeAgent(_worker().conductor_address, {"CPU": 4.0}).start()
    new = None
    try:
        s = Survivor.options(
            num_cpus=2, name="late-node-survivor",
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                agent.node_id)).remote()
        n, _, pid = rt.get(s.inc.remote(), timeout=60.0)
        assert n == 1
        _wait_snapshot()
        # the agent's heartbeat loop waits for `resume` before its next
        # heartbeat, so its worker re-registers (every 5 s) first. The
        # loop asks for the period once its current wait and beat are
        # over: `parked` says it has, however late a loaded machine
        # runs the beat.
        node_agent._heartbeat_period = park
        assert parked.wait(30.0), "the agent's heartbeat loop never parked"
        new = _crash_and_restart({"CPU": 4.0})
        _wait_until(lambda: any(
            wk["pid"] == pid for wk in new.handler.list_workers()), 15.0,
            "the actor's worker never re-registered")
        assert agent.node_id not in {n["node_id"] for n in rt.nodes()}
        time.sleep(1.0)  # monitor ticks: the worker known, its node not
        node_agent._heartbeat_period = period
        resume.set()

        def agent_cpus():
            n = [n for n in rt.nodes() if n["node_id"] == agent.node_id]
            return n[0]["available"]["CPU"] if n else None

        _wait_until(lambda: agent_cpus() == 2.0, 20.0,
                    lambda: f"the actor's lease not charged again: "
                    f"{agent_cpus()}")
        h = rt.get_actor("late-node-survivor")
        assert rt.get(h.inc.remote(), timeout=60.0)[:3:2] == (2, pid)
    finally:
        node_agent._heartbeat_period = period
        resume.set()
        agent.stop()
        if new is not None:
            new.stop()


def port_restart_gpu_worker_keeps_its_gpu():
    """A GPU worker outlives a conductor crash and keeps its GPU: the
    restarted conductor restores its record before it accepts a call,
    the worker re-registers, a new num_gpus=1 lease on the one-GPU head
    waits while it lives, and gets the same GPU once it is gone."""
    old = _set_visible("7")
    new = None
    try:
        rt.init(num_cpus=2, resources={"GPU": 1})
        s = Survivor.options(num_gpus=1, name="gpu-survivor").remote()
        n, visible, pid = rt.get(s.inc.remote(), timeout=60.0)
        assert (n, visible) == (1, "7")
        _wait_snapshot()
        new = _crash_and_restart({"CPU": 2.0, "GPU": 1.0}, gpu_ids=["7"])
        h = rt.get_actor("gpu-survivor")
        assert rt.get(h.inc.remote(), timeout=60.0) == (2, "7", pid)
        _wait_until(lambda: any(
            wk["pid"] == pid for wk in new.handler.list_workers()), 20.0,
            "the GPU worker never re-registered")
        assert rt.available_resources()["GPU"] == 0.0

        @rt.remote(num_gpus=1)
        def gpu_task():
            return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

        ref = gpu_task.remote()
        ready, _ = rt.wait([ref], timeout=3.0)
        assert not ready, "a second lease got the survivor's GPU"
        assert not pid_exited(pid)
        rt.kill(h)
        visible2, pid2 = rt.get(ref, timeout=60.0)
        assert visible2 == "7" and pid2 != pid
        assert pid_exited(pid), "the GPU was leased before its holder exited"
    finally:
        _restore_visible(old)
        if new is not None:
            new.stop()


# ------------------------------------------------------------ log monitor
# twins of tests/test_log_monitor.py

class _Capture:
    """A stand-in for sys.stderr that keeps what is written."""

    def __init__(self):
        self.parts = []
        self.lock = threading.Lock()

    def write(self, s):
        with self.lock:
            self.parts.append(s)
        return len(s)

    def flush(self):
        pass

    def text(self):
        with self.lock:
            return "".join(self.parts)


def log_tailer_incremental_and_partial_lines():
    from ray_tpu_torch._private.log_monitor import LogMonitor

    logs = tempfile.mkdtemp(dir=rt.session_root())
    path = os.path.join(logs, "worker-abc123.log")
    mon = LogMonitor(logs, lambda batch: None, node_label="n1")
    with open(path, "wb") as f:
        f.write(b"hello\nworld\npart")
    got = mon.poll_once()
    assert [e["line"] for e in got] == ["hello", "world"]
    assert got[0]["worker"] == "abc123" and got[0]["node"] == "n1"
    with open(path, "ab") as f:
        f.write(b"ial done\nnext\n")
    assert [e["line"] for e in mon.poll_once()] == ["partial done", "next"]
    assert mon.poll_once() == []


def log_tailer_survives_truncation():
    from ray_tpu_torch._private.log_monitor import LogMonitor

    logs = tempfile.mkdtemp(dir=rt.session_root())
    path = os.path.join(logs, "worker-w1.log")
    mon = LogMonitor(logs, lambda batch: None)
    with open(path, "wb") as f:
        f.write(b"a long first line\n")
    assert [e["line"] for e in mon.poll_once()] == ["a long first line"]
    with open(path, "wb") as f:  # rotate: truncate to smaller
        f.write(b"fresh\n")
    assert [e["line"] for e in mon.poll_once()] == ["fresh"]


def log_format_prefix():
    from ray_tpu_torch._private.log_monitor import format_log_line

    s = format_log_line({"worker": "ab12", "node": "head", "line": "hi"})
    assert s == "(worker=ab12, node=head) hi"


def _driver_stderr_after_print(marker: str, wait_s: float) -> str:
    """What the driver's stderr received within `wait_s` of a task
    printing `marker` (returns as soon as the marker arrives)."""
    cap, old = _Capture(), sys.stderr
    sys.stderr = cap
    try:
        @rt.remote
        def chatty():
            print(marker)
            return 1

        assert rt.get(chatty.remote(), timeout=60.0) == 1
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline and marker not in cap.text():
            time.sleep(0.1)
        return cap.text()
    finally:
        sys.stderr = old


def log_worker_prints_reach_driver():
    """A task's print() shows up on the driver's stderr."""
    seen = _driver_stderr_after_print("MARKER_FROM_TASK_42", 10.0)
    assert "MARKER_FROM_TASK_42" in seen and "(worker=" in seen, seen[-500:]


def log_to_driver_disabled():
    seen = _driver_stderr_after_print("MARKER_SILENCED_99", 2.0)
    assert "MARKER_SILENCED_99" not in seen


def log_burst_beyond_tick_cap_is_retained():
    """Lines past the per-tick cap inside an already-read chunk are kept
    for the next tick, not dropped."""
    from ray_tpu_torch._private.log_monitor import (_MAX_LINES_PER_TICK,
                                                    LogMonitor)

    logs = tempfile.mkdtemp(dir=rt.session_root())
    path = os.path.join(logs, "worker-burst.log")
    with open(path, "w") as f:
        for i in range(_MAX_LINES_PER_TICK + 50):
            f.write(f"line-{i}\n")
        f.write("partial-no-newline")
    lm = LogMonitor(logs, publish_fn=lambda b: None, node_label="n")
    g1, g2, g3 = lm.poll_once(), lm.poll_once(), lm.poll_once()
    assert len(g1) == _MAX_LINES_PER_TICK
    assert [e["line"] for e in g2] == [
        f"line-{i}" for i in range(_MAX_LINES_PER_TICK,
                                   _MAX_LINES_PER_TICK + 50)]
    assert g3 == []
    with open(path, "a") as f:
        f.write("-done\n")
    assert [e["line"] for e in lm.poll_once()] == ["partial-no-newline-done"]


# --------------------------------------------------------- memory monitor
# twins of tests/test_memory_monitor.py

def mem_threshold_logic():
    from ray_tpu_torch._private.memory_monitor import MemoryMonitor

    assert MemoryMonitor(0.9, usage_fn=lambda: (95, 100)
                         ).over_threshold() == (95, 100)
    assert MemoryMonitor(0.9, usage_fn=lambda: (50, 100)
                         ).over_threshold() is None
    assert MemoryMonitor(0.0, usage_fn=lambda: (100, 100)
                         ).over_threshold() is None


def mem_victim_prefers_busy_then_rss():
    from ray_tpu_torch._private.memory_monitor import MemoryMonitor

    rss = {1: 100, 2: 900, 3: 500, 4: 5000}
    mon = MemoryMonitor(0.9, rss_fn=lambda pid: rss.get(pid, 0))
    assert mon.pick_victim([("w1", 1, "BUSY"), ("w2", 2, "BUSY"),
                            ("w3", 3, "ACTOR"), ("w4", 4, "ACTOR")]) == \
        ("w2", 2, 900)
    assert mon.pick_victim([("w3", 3, "ACTOR"), ("w4", 4, "ACTOR")]) == \
        ("w4", 4, 5000)
    assert mon.pick_victim([("w9", 9, "BUSY")]) is None
    assert mon.pick_victim([]) is None


def mem_real_readers_sane():
    from ray_tpu_torch._private.memory_monitor import node_usage, pid_rss

    used, total = node_usage()
    assert 0 < used <= total
    assert pid_rss(os.getpid()) > 1024 * 1024
    assert pid_rss(2 ** 22 + 12345) == 0


OOM = {"num_cpus": 2, "_system_config": {
    "memory_usage_threshold": 1e-9, "memory_monitor_refresh_ms": 100}}


def mem_oom_kill_surfaces_typed_error():
    """A threshold of ~0 makes any usage 'over': the running task's
    worker is killed and the caller gets OutOfMemoryError."""
    @rt.remote(max_retries=0)
    def hog():
        time.sleep(30)
        return "survived"

    e = _raises(exc.OutOfMemoryError, rt.get, hog.remote(), timeout=30.0)
    assert "oom" in str(e), e


def mem_oom_retries_then_fails_typed():
    """OOM kills consume retries like any worker death; the last error
    is still the typed one."""
    @rt.remote(max_retries=1)
    def hog():
        time.sleep(30)

    _raises(exc.WorkerCrashedError, rt.get, hog.remote(), timeout=60.0)


# ---------------------------------------------- CLI, jobs, remote drivers
# twins of tests/test_cli_jobs.py and test_remote_driver.py, each on a
# standalone head of its own (`python -m ray_tpu_torch start --head`)

class StandaloneHead:
    """A head process, its files under the run's directory."""

    def __init__(self, *args: str, num_cpus: int = 4):
        tmp = os.path.join(rt.session_root(), f"head-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        self.env = _child_env(TMPDIR=tmp)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
             "--num-cpus", str(num_cpus), "--num-gpus", "0", *args],
            env=self.env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.address = None
        deadline = time.monotonic() + 60.0
        line = ""
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            m = re.search(r"started at ([\d.]+:\d+)", line or "")
            if m:
                self.address = m.group(1)
                break
        assert self.address, f"head never came up: {line!r}"

    def cli(self, *args, check=True) -> str:
        r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                           env=dict(self.env, RTT_ADDRESS=self.address),
                           capture_output=True, text=True, timeout=120)
        if check:
            assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    def stop(self) -> None:
        """`stop`: the head ends the cluster and exits 0."""
        try:
            self.cli("stop", "--address", self.address)
            assert self.proc.wait(timeout=20) == 0
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def _with_head(fn, *args: str):
    head = StandaloneHead(*args)
    try:
        fn(head)
    finally:
        if rt.is_initialized():
            rt.shutdown()
        head.stop()


def cli_connect_to_standalone_head():
    def body(head):
        rt.init(address=head.address)

        @rt.remote
        def f(x):
            return x * 2

        assert rt.get(f.remote(21), timeout=60.0) == 42

    _with_head(body)


def cli_status_and_list():
    def body(head):
        out = json.loads(head.cli("status"))
        assert out["resources_total"]["CPU"] == 4.0
        assert len(json.loads(head.cli("list", "nodes"))) >= 1

    _with_head(body)


def cli_job_submit_and_logs():
    def body(head):
        from ray_tpu_torch._private.worker_spawn import _repo_env
        from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

        env = {}
        _repo_env(env)
        client = JobSubmissionClient(head.address)
        script = ("import ray_tpu_torch as rt; rt.init(address='auto'); "
                  "print('job-result:', rt.get(rt.remote("
                  "lambda: 6 * 7).remote()))")
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"{script}\"",
            runtime_env={"env_vars": env})
        status = client.wait_until_finished(job_id, timeout=120.0)
        logs = client.get_job_logs(job_id)
        assert status == JobStatus.SUCCEEDED, logs
        assert "job-result: 42" in logs
        assert any(j["job_id"] == job_id for j in client.list_jobs())

    _with_head(body)


def cli_job_failure_status():
    def body(head):
        from ray_tpu_torch.job_submission import JobSubmissionClient

        client = JobSubmissionClient(head.address)
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
        assert client.wait_until_finished(job_id, timeout=60.0) == "FAILED"

    _with_head(body)


def cli_job_stop():
    def body(head):
        from ray_tpu_torch.job_submission import JobSubmissionClient

        client = JobSubmissionClient(head.address)
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
        _wait_until(lambda: client.get_job_status(job_id) == "RUNNING",
                    30.0, "job never ran")
        assert client.stop_job(job_id)
        assert client.wait_until_finished(job_id, timeout=30.0) == "STOPPED"

    _with_head(body)


def cli_job_roundtrip():
    def body(head):
        job_id = head.cli("job", "--address", head.address, "submit",
                          sys.executable, "-c", "print('cli-job-ok')").strip()
        status = None

        def done():
            nonlocal status
            status = head.cli("job", "--address", head.address, "status",
                              job_id).strip()
            return status in ("SUCCEEDED", "FAILED", "STOPPED")

        _wait_until(done, 60.0, "job never finished")
        assert status == "SUCCEEDED"
        assert "cli-job-ok" in head.cli("job", "--address", head.address,
                                        "logs", job_id)

    _with_head(body)


@rt.remote
class Acc:
    def __init__(self):
        self.total = 0

    def add(self, x):
        self.total += x
        return self.total


def remote_external_driver_runs_tasks_and_actors():
    def body(head):
        rt.init(address=head.address)

        @rt.remote
        def add(a, b):
            return a + b

        assert rt.get(add.remote(2, 3), timeout=60.0) == 5
        a = Acc.options(name="shared-acc").remote()
        assert rt.get(a.add.remote(10), timeout=60.0) == 10
        assert rt.cluster_resources()["CPU"] == 4.0

    _with_head(body)


_SECOND_DRIVER = r"""
import sys
import ray_tpu_torch as rt

rt.init(address=sys.argv[1])
h = rt.get_actor("cross-driver")
print("SECOND_SEES", rt.get(h.add.remote(5), timeout=60.0), flush=True)
rt.shutdown()
"""


def remote_two_drivers_share_named_actors():
    def body(head):
        rt.init(address=head.address)
        a = Acc.options(name="cross-driver").remote()
        assert rt.get(a.add.remote(1), timeout=60.0) == 1
        out = subprocess.run(
            [sys.executable, "-c", _SECOND_DRIVER, head.address],
            env=_child_env(), capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "SECOND_SEES 6" in out.stdout
        assert rt.get(a.add.remote(0), timeout=60.0) == 6

    _with_head(body)


def port_standalone_head_flags_and_maintenance_event():
    """A standalone head takes its flags from `start --head
    --system-config` and its maintenance-event file from
    `--maintenance-event`: an agent joining it runs with the head's
    flags, and the file's appearance drains the head's node."""
    from ray_tpu_torch._private.rpc import RpcClient

    spec = os.path.join(tempfile.mkdtemp(dir=rt.session_root()),
                        "maint.json")
    flags = {"node_heartbeat": 0.25, "maintenance_poll_s": 0.05}

    agents = []

    def body(head):
        rt.init(address=head.address)
        agent, agent_id = start_agent(num_cpus=1)
        agents.append(agent)
        node = next(n for n in rt.nodes() if n["node_id"] == agent_id)
        c = RpcClient(tuple(node["address"]))
        try:
            snap = c.call("config_snapshot", timeout=10.0)
        finally:
            c.close()
        assert {k: snap.get(k) for k in flags} == flags, snap
        head_id = next(n["node_id"] for n in rt.nodes() if n["head"])
        with open(spec, "w") as f:
            json.dump({"grace_s": 30.0, "reason": "maintenance"}, f)
        _wait_until(lambda: _conductor().call(
            "get_resilience_status", timeout=10.0)["excluded"]
            == [head_id], 10.0, "the head never drained")

    try:
        _with_head(body, "--system-config", json.dumps(flags),
                   "--maintenance-event", spec)
    finally:
        for agent in agents:  # the head's stop ended it
            try:
                agent.wait(timeout=15)
            finally:
                _end(agent)


def port_shutdown_cluster_refused_in_driver():
    """shutdown_cluster would end the process hosting the conductor: in
    a driver it raises, and the cluster goes on. (A standalone head
    exits 0 on it: every StandaloneHead.stop above checks that.)"""
    from ray_tpu_torch._private.rpc import RemoteError

    e = _raises(RemoteError, _conductor().call, "shutdown_cluster",
                timeout=10.0)
    assert isinstance(e.cause, RuntimeError) and "driver" in str(e.cause), e
    time.sleep(0.5)
    assert _conductor().call("ping", timeout=10.0) == "pong"
    assert rt.get(rt.put(7)) == 7


_JOB_SCRIPT = r"""
import json, os
import ray_tpu_torch as rt

info = rt.init()  # the job's head, from RTT_ADDRESS
seen = {k: os.environ.get(k) for k in
        ("RTT_ADDRESS", "RTT_JOB_ID", "RTT_CHECK_MARKER")}
seen["ray_tpu_vars"] = sorted(k for k in os.environ
                              if k in ("RAY_TPU_ADDRESS", "RAY_TPU_JOB_ID"))
seen["address"] = "%s:%s" % tuple(info["address"])
seen["session_dir"] = info["session_dir"]
seen["answer"] = rt.get(rt.remote(lambda: 41 + 1).remote())
print("WIRING", json.dumps(seen), flush=True)
rt.shutdown()
"""


def port_job_wiring_variables():
    """A job runs in the head's environment with RTT_ADDRESS and
    RTT_JOB_ID set (no RAY_TPU_* variable), and a plain init() inside it
    finds the cluster and shares the head's session directory;
    init(address="auto") without RTT_ADDRESS raises."""
    from ray_tpu_torch._private.conductor import ENV_ADDRESS

    os.environ.pop(ENV_ADDRESS, None)
    e = _raises(RuntimeError, rt.init, address="auto")
    assert ENV_ADDRESS in str(e), e
    assert not rt.is_initialized()
    os.environ["RTT_CHECK_MARKER"] = "from-the-head"
    try:
        info = rt.init(num_cpus=2)
        from ray_tpu_torch.job_submission import JobSubmissionClient

        path = os.path.join(info["session_dir"], "wiring.py")
        with open(path, "w") as f:
            f.write(_JOB_SCRIPT)
        client = JobSubmissionClient()
        job_id = client.submit_job(entrypoint=f"{sys.executable} {path}")
        status = client.wait_until_finished(job_id, timeout=120.0)
        logs = client.get_job_logs(job_id)
        assert status == "SUCCEEDED", logs
        seen = json.loads(logs.split("WIRING ", 1)[1].splitlines()[0])
        host, port = _worker().conductor_address
        assert seen["RTT_ADDRESS"] == seen["address"] == f"{host}:{port}", \
            seen
        assert seen["RTT_JOB_ID"] == job_id, seen
        assert seen["RTT_CHECK_MARKER"] == "from-the-head", seen
        assert seen["ray_tpu_vars"] == [], seen
        assert seen["session_dir"] == info["session_dir"], seen
        assert seen["answer"] == 42, seen
    finally:
        os.environ.pop("RTT_CHECK_MARKER", None)


# ------------------------------------------------------------ resilience
# twins of the tracker, channel and conductor-policy cases of
# tests/test_resilience.py

def res_tracker_threshold_decay_and_exempt():
    from ray_tpu_torch.resilience import FailureDomainTracker

    clock = [0.0]
    t = FailureDomainTracker(threshold=2.0, half_life_s=10.0,
                             exempt=("head",), clock=lambda: clock[0])
    assert t.score("h1") == 0.0 and not t.is_quarantined("h1")
    t.record("h1", "worker_death")
    assert not t.is_quarantined("h1")
    t.record("h1", "worker_death", detail="oom: greedy")
    assert t.is_quarantined("h1")
    clock[0] = 10.0
    assert abs(t.score("h1") - 1.0) < 1e-9
    assert t.is_quarantined("h1")
    clock[0] = 20.0
    assert not t.is_quarantined("h1")
    for _ in range(10):
        t.record("head", "worker_death")
    assert not t.is_quarantined("head")
    assert "head" not in t.excluded()


def res_tracker_drain_and_manual_quarantine():
    from ray_tpu_torch.resilience import FailureDomainTracker

    clock = [0.0]
    t = FailureDomainTracker(threshold=3.0, half_life_s=60.0,
                             clock=lambda: clock[0])
    t.begin_drain("h1", deadline=5.0, reason="preemption")
    assert t.is_draining("h1") and t.is_excluded("h1")
    assert not t.is_quarantined("h1")
    clock[0] = 5.1
    assert not t.is_excluded("h1")
    t.quarantine("h2", "operator")
    assert t.is_quarantined("h2")
    st = t.status()["domains"]["h2"]
    assert st["manual"] and st["quarantined"]
    assert t.clear("h2") and not t.is_quarantined("h2")
    t2 = FailureDomainTracker(exempt=("head",), clock=lambda: clock[0])
    t2.quarantine("head", "operator")
    assert t2.is_quarantined("head") and "head" in t2.excluded()
    t2.clear("head")
    assert not t2.is_quarantined("head")


def res_maintenance_event_channel():
    from ray_tpu_torch.resilience import (PreemptionWatcher,
                                          read_maintenance_event)

    spec = os.path.join(tempfile.mkdtemp(dir=rt.session_root()),
                        "maint.json")
    assert read_maintenance_event(spec) is None
    events = []
    w = PreemptionWatcher(events.append, spec=spec, poll_s=0.01)
    assert w.poll_once() is None
    with open(spec, "w") as f:
        json.dump({"grace_s": 7.5, "reason": "spot-reclaim"}, f)
    ev = w.poll_once()
    assert ev is not None and ev.grace_s == 7.5
    assert ev.reason == "spot-reclaim"
    assert w.poll_once() is None  # fires once per event
    os.unlink(spec)
    assert w.poll_once() is None  # channel cleared: re-armed
    open(spec, "w").close()       # empty file -> defaults apply
    ev = w.poll_once()
    assert ev is not None and ev.reason == "maintenance"
    assert events and events[0].grace_s == 7.5


def _policy_handler():
    """The JAX tests' `handler` fixture: a bare ConductorHandler (no
    server, no monitor) with quarantine threshold 1.0 and one
    accounting node."""
    from ray_tpu_torch._private.conductor import ConductorHandler
    from ray_tpu_torch._private.config import config

    prior = config.apply({"quarantine_threshold": 1.0})
    try:
        h = ConductorHandler({"CPU": 2.0},
                             tempfile.mkdtemp(dir=rt.session_root()))
    finally:
        config.restore(prior)
    h.register_node("flaky-host", {"CPU": 4.0}, None)
    return h


def res_conductor_preemption_drains_and_expires():
    h = _policy_handler()
    try:
        ev = h.report_preemption(node_id="flaky-host", grace_s=0.25,
                                 reason="test")
        assert ev["kind"] == "preemption" and ev["grace_s"] == 0.25
        st = h.get_resilience_status()
        assert st["excluded"] == ["flaky-host"]
        assert st["domains"]["flaky-host"]["draining"]
        assert st["counters"]["preemption"] == 1
        assert h.schedulable_resources() == {"CPU": 2.0}
        time.sleep(0.3)
        assert h.get_resilience_status()["excluded"] == []
    finally:
        h._stopped = True


def res_conductor_quarantine_excludes_from_leases_and_bundles():
    from ray_tpu_torch._private.conductor import WorkerRecord

    h = _policy_handler()
    try:
        dead = WorkerRecord(worker_id="w1", node_id=h._head_node_id,
                            lease_node_id="flaky-host",
                            death_cause="oom: greedy")
        h._on_worker_death(dead)
        st = h.get_resilience_status()
        assert "flaky-host" in st["excluded"]
        assert st["domains"]["flaky-host"]["quarantined"]
        assert st["counters"]["worker_death"] == 1
        assert st["counters"]["quarantine"] == 1
        _raises(ValueError, h.create_placement_group,
                [{"CPU": 1.0}] * 3, "STRICT_PACK")
        _raises(TimeoutError, h.lease_worker, {"CPU": 3.0}, timeout=0.3)
        assert h.clear_quarantine("flaky-host")
        h.create_placement_group([{"CPU": 1.0}] * 3, "STRICT_PACK")
        gone = WorkerRecord(worker_id="w2", node_id=h._head_node_id,
                            lease_node_id="flaky-host", expected_death=True)
        h._on_worker_death(gone)
        assert h.get_resilience_status()["excluded"] == []
    finally:
        h._stopped = True


def port_agent_maintenance_event_argument():
    """The maintenance-event file is the agent's argument, not an
    environment variable: the file's appearance drains the agent's node
    and reaches a `resilience` subscriber; RAY_TPU_MAINTENANCE_EVENT
    naming an existing file changes nothing."""
    from ray_tpu_torch._private.node_agent import NodeAgent

    tmp = tempfile.mkdtemp(dir=rt.session_root())
    ignored = os.path.join(tmp, "ignored.json")
    with open(ignored, "w") as f:
        json.dump({"grace_s": 99}, f)
    os.environ["RAY_TPU_MAINTENANCE_EVENT"] = ignored
    spec = os.path.join(tmp, "maint.json")
    got, arrived = [], threading.Event()

    def on_event(msg):
        got.append(msg)
        arrived.set()

    _worker().subscribe_channel("resilience", on_event)
    agent = NodeAgent(_worker().conductor_address, {"CPU": 1.0},
                      maintenance_event=spec).start()
    plain = NodeAgent(_worker().conductor_address, {"CPU": 1.0}).start()
    try:
        time.sleep(0.5)
        assert not arrived.is_set(), got
        with open(spec, "w") as f:
            json.dump({"grace_s": 5.0, "reason": "spot"}, f)
        assert arrived.wait(10.0), "no resilience broadcast"
        assert got[0]["node_id"] == agent.node_id and \
            got[0]["grace_s"] == 5.0 and got[0]["reason"] == "spot", got
        c = _conductor()
        st = c.call("get_resilience_status", timeout=10.0)
        assert st["excluded"] == [agent.node_id], st
        assert st["counters"] == {"preemption": 1}, st
        events = c.call("get_resilience_events", timeout=10.0)
        assert [e["kind"] for e in events] == ["preemption"], events
        # an operator pin on the other agent, then its release
        c.call("quarantine_node", plain.node_id, "operator", timeout=10.0)
        st = c.call("get_resilience_status", timeout=10.0)
        assert sorted(st["excluded"]) == sorted([agent.node_id,
                                                 plain.node_id]), st
        assert c.call("clear_quarantine", plain.node_id, timeout=10.0)
        assert c.call("get_resilience_status", timeout=10.0)[
            "excluded"] == [agent.node_id]
        assert [e["kind"] for e in c.call("get_resilience_events",
                                          timeout=10.0)] == [
            "preemption", "quarantine", "quarantine_cleared"]
    finally:
        os.environ.pop("RAY_TPU_MAINTENANCE_EVENT", None)
        agent.stop()
        plain.stop()
