"""The port's runtime (ray_tpu_torch) against the JAX package's, in
pure Python: the flag table, the ids, the exception hierarchy, the
scheduling strategies' wire form and serialization (numpy payloads
through both packages' serialize/deserialize, torch tensors through the
port's). Nothing here starts a cluster or a process, or loads the arena
library: the runtime's checks run in isolated drivers
(tests/test_torch_runtime_*.py).
"""
from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from ray_tpu import exceptions as jexc
from ray_tpu._private import config as jconfig
from ray_tpu._private import ids as jids
from ray_tpu._private import serialization as jser
from ray_tpu.util import scheduling_strategies as jsched
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch._private import config as tconfig
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch.util import scheduling_strategies as tsched

# the JAX package's flags without a counterpart (config.py's docstring),
# with the reason
_NOT_PORTED = "its subsystem is not ported (ROADMAP Queue 1)"
JAX_ONLY_FLAGS = {
    "chips": "the port counts GPUs; init(resources=) sets the count",
    "pallas_interpret": "the port has no Pallas kernel",
    **{name: _NOT_PORTED for name in (
        "data_memory_budget", "data_shm_high_water",
        "restart_backoff_base_s", "restart_backoff_max_s", "node_ip",
        "workflow_storage")},
}
# the flags the cluster layer and the weight fabric brought back (they
# were JAX_ONLY_FLAGS until then): each is read by the port, under the
# JAX name, type and default
CLUSTER_FLAGS = ("node_timeout", "node_heartbeat", "node_orphan_grace",
                 "restore_grace", "memory_usage_threshold",
                 "memory_monitor_refresh_ms", "log_to_driver",
                 "preempt_grace_s", "maintenance_poll_s",
                 "quarantine_threshold", "quarantine_halflife_s",
                 # and the weight fabric's registry
                 "weights_keep", "weights_publish_ttl_s")
# the port's flags in place of the JAX package's environment reads, with
# the defaults of those reads (rpc.py:92, worker_spawn.py:137,
# worker_main.py:39)
PORT_ONLY_FLAGS = {"rpc_warn_ms": (float, 5000.0),
                   "no_fork_server": (int, 0),
                   "worker_verbose": (int, 0)}


def test_flag_table_matches_jax():
    jflags = {f.name: f for f in jconfig._FLAGS}
    tflags = {f.name: f for f in tconfig._FLAGS}
    assert set(jflags) - set(tflags) == set(JAX_ONLY_FLAGS)
    assert set(tflags) - set(jflags) == set(PORT_ONLY_FLAGS)
    for name in set(jflags) & set(tflags):
        assert (tflags[name].type, tflags[name].default) == \
            (jflags[name].type, jflags[name].default), name
    for name, (typ, default) in PORT_ONLY_FLAGS.items():
        assert (tflags[name].type, tflags[name].default) == (typ, default)
    # and the port's table resolves to the defaults, whatever the
    # environment says
    assert {r["name"]: r["value"] for r in tconfig.RayTpuConfig().describe()
            } == {n: f.default for n, f in tflags.items()}


@pytest.mark.parametrize("name", sorted(JAX_ONLY_FLAGS))
def test_jax_only_flag_is_refused(name):
    """A flag without a counterpart is unknown to the port: setting it
    raises instead of doing nothing."""
    cfg = tconfig.RayTpuConfig()
    with pytest.raises(ValueError, match="unknown _system_config flag"):
        cfg.apply({name: jconfig._BY_NAME[name].default})
    with pytest.raises(KeyError):
        cfg.get(name)
    assert cfg.snapshot() == {}


@pytest.mark.parametrize("name", CLUSTER_FLAGS)
def test_cluster_flag_is_read_with_jax_default(name):
    """A flag of the cluster layer resolves to the JAX package's default,
    an override holds until restored, and the port's code reads it."""
    import pathlib

    jflag = jconfig._BY_NAME[name]
    cfg = tconfig.RayTpuConfig()
    assert cfg.get(name) == jflag.default
    assert type(cfg.get(name)) is jflag.type
    bumped = jflag.type(jflag.default * 2 if jflag.default else 1)
    prior = cfg.apply({name: bumped})
    assert cfg.get(name) == bumped and cfg.snapshot() == {name: bumped}
    cfg.restore(prior)
    assert cfg.get(name) == jflag.default
    pkg = pathlib.Path(tconfig.__file__).parents[1]
    readers = [p for p in pkg.rglob("*.py") if p.name != "config.py"
               and f"config.{name}" in p.read_text()]
    assert readers, f"no module of the port reads config.{name}"


ID_CLASSES = ["BaseID", "JobID", "NodeID", "TaskID", "ActorID", "ObjectID",
              "PlacementGroupID", "WorkerID"]


@pytest.mark.parametrize("name", ID_CLASSES)
def test_ids_match_jax(name):
    jcls, tcls = getattr(jids, name), getattr(tids, name)
    assert tcls._prefix == jcls._prefix
    fresh = tcls()
    assert len(fresh.hex()) == len(jcls().hex()) == 32
    h = jcls().hex()
    j, t = jcls(h), tcls.from_hex(h)
    assert (t.hex(), t.binary(), repr(t)) == (j.hex(), j.binary(), repr(j))
    assert pickle.loads(pickle.dumps(t)) == t
    assert t == tcls(h) and hash(t) == hash(tcls(h))
    assert t != tcls()


def test_seqno_is_monotonic():
    a = tids.next_seqno()
    assert tids.next_seqno() == a + 1


def _exception_classes(mod):
    return {n: c for n, c in vars(mod).items()
            if isinstance(c, type) and issubclass(c, BaseException)
            and c.__module__ == mod.__name__}


@pytest.mark.parametrize("name", sorted(_exception_classes(jexc)))
def test_exception_hierarchy_matches_jax(name):
    jcls = _exception_classes(jexc)[name]
    tcls = _exception_classes(texc)[name]
    assert [b.__name__ for b in tcls.__mro__] == \
        [b.__name__ for b in jcls.__mro__]


def test_exceptions_have_no_extra_classes():
    assert set(_exception_classes(texc)) == set(_exception_classes(jexc))


@pytest.mark.parametrize("make", [
    lambda m: m.TaskError(ValueError("boom"), "tb", "f"),
    lambda m: m.ActorDiedError("a" * 32, "gone"),
    lambda m: m.ObjectLostError("b" * 32, "lost it"),
    lambda m: m.GetTimeoutError("late"),
], ids=["task", "actor", "object_lost", "timeout"])
def test_exception_messages_match_jax(make):
    assert str(make(texc)) == str(make(jexc))


STRATEGIES = [None, "DEFAULT", "SPREAD", ("affinity", "n1", False),
              ("affinity", "n2", True)]


@pytest.mark.parametrize("strategy", STRATEGIES,
                         ids=lambda s: str(s).replace(" ", ""))
def test_strategy_wire_matches_jax(strategy):
    def make(mod):
        if isinstance(strategy, tuple):
            return mod.NodeAffinitySchedulingStrategy(strategy[1],
                                                      strategy[2])
        return strategy

    assert tsched.to_wire(make(tsched)) == jsched.to_wire(make(jsched))


def test_strategy_errors_match_jax():
    for bad, err in (("PACK", ValueError), (3, TypeError)):
        with pytest.raises(err):
            jsched.to_wire(bad)
        with pytest.raises(err):
            tsched.to_wire(bad)


def _numpy_payloads():
    rng = np.random.default_rng(0)
    big = rng.standard_normal((300, 400))
    return {
        "float32": rng.standard_normal(1000).astype(np.float32),
        "int64_large": rng.integers(-9, 9, size=200_000),
        "non_contiguous": big[::2, 1::3],
        "zero_d": np.array(2.5),
        "empty": np.zeros((0, 3), np.float16),
        "nested": {"a": np.arange(10, dtype=np.uint8), "b": [1, "x"],
                   "c": (np.ones((2, 2), np.complex64), None)},
    }


@pytest.mark.parametrize("name", sorted(_numpy_payloads()))
def test_numpy_payloads_serialize_like_jax(name):
    value = _numpy_payloads()[name]
    tmeta, tbufs = tser.serialize(value)
    jmeta, jbufs = jser.serialize(value)
    assert [bytes(b) for b in tbufs] == [bytes(b) for b in jbufs]
    # each package reads the other's payload
    for meta, bufs, load in ((tmeta, tbufs, jser.deserialize),
                             (jmeta, jbufs, tser.deserialize),
                             (tmeta, tbufs, tser.deserialize)):
        got = load(meta, [memoryview(bytes(b)) for b in bufs])
        np.testing.assert_equal(got, value)
    np.testing.assert_equal(tser.loads(tser.dumps(value)), value)


def _tensor_cases():
    g = torch.Generator().manual_seed(0)
    big = torch.randn(256, 300, generator=g)
    return big, {
        "bf16": torch.randn(17, 9, generator=g).to(torch.bfloat16),
        "fp16": torch.randn(5, 4, generator=g).half(),
        "fp32": torch.randn(6, 7, generator=g),
        "int64": torch.arange(-20, 20),
        "int8": torch.arange(-8, 8, dtype=torch.int8),
        "bool": torch.rand(9, generator=g) > 0.5,
        "zero_d": torch.tensor(-1.5),
        "empty": torch.empty(0, 5, dtype=torch.bfloat16),
        "non_contiguous": big.t()[::7],
        "offset_view": big[40:43, 100:117],
        "parameter": torch.nn.Parameter(torch.randn(4, 4, generator=g)),
        "requires_grad": torch.randn(3, generator=g).requires_grad_(True),
    }


def _same(got, want):
    assert type(got) is type(want)
    assert got.device.type == "cpu"
    assert (got.dtype, got.shape, got.requires_grad) == \
        (want.dtype, want.shape, want.requires_grad)
    assert torch.equal(got.detach(), want.detach())


@pytest.mark.parametrize("name", sorted(_tensor_cases()[1]))
def test_tensor_round_trips(name):
    t = _tensor_cases()[1][name]
    meta, bufs = tser.serialize(t)
    # one out-of-band buffer holding the view's bytes, no more
    assert [b.nbytes for b in bufs] == [t.numel() * t.element_size()]
    _same(tser.deserialize(meta, [memoryview(bytes(b)) for b in bufs]), t)
    _same(tser.loads(tser.dumps(t)), t)  # in band, as RPC frames carry it


def test_tensor_view_ships_only_its_bytes():
    big, cases = _tensor_cases()
    view = cases["offset_view"]
    _, bufs = tser.serialize(view)
    assert sum(b.nbytes for b in bufs) == 3 * 17 * 4 < big.numel()
    assert len(tser.dumps(view)) < 1024
    assert len(pickle.dumps(view)) > big.numel() * 4  # torch's own pickle


def test_tensors_inside_containers():
    _, cases = _tensor_cases()
    payload = {"tensors": cases, "array": np.arange(5), "n": 3}
    meta, bufs = tser.serialize(payload)
    got = tser.deserialize(meta, [memoryview(bytes(b)) for b in bufs])
    for name, t in cases.items():
        _same(got["tensors"][name], t)
    np.testing.assert_array_equal(got["array"], payload["array"])
