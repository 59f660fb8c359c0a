"""The collective actors of the port (ray_tpu_torch/util/collective.py,
the worker's `__ray_tpu_col_init__` hook) against the JAX package's, on
the CPU.

Twins of tests/test_collective.py's host-plane cases, each a check of
`_private/mpmd_checks.py` run in a driver process of its own
(`isolated.run_checks`) on the JAX test's `Rank` actor
(`mpmd_checks.ColRank`); the results are held here against the JAX
test's expected values. Added: a group destroyed by both ranks leaves
only its final barrier's markers in the conductor's KV.

Not twinned: test_device_allreduce (`device_allreduce`, the JAX device
plane, ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from ray_tpu.util import collective as jcol
from ray_tpu_torch._private import isolated
from ray_tpu_torch.util import collective as tcol

CHECKS = {name: {"num_cpus": 4} for name in (
    "collective_allreduce",
    "collective_broadcast_allgather",
    "collective_reducescatter_sendrecv_barrier",
    "collective_declarative_create_group",
    "collective_destroy_leaves_only_final_barrier")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


def _value(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
    return json.loads(text)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_collective_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_allreduce(outcomes):
    for r in _value(outcomes, "collective_allreduce")["allreduce"]:
        np.testing.assert_allclose(r, np.full((4,), 3.0))


def test_broadcast_allgather(outcomes):
    out = _value(outcomes, "collective_broadcast_allgather")
    for r in out["broadcast"]:
        np.testing.assert_allclose(r, np.arange(3, dtype=np.float32))
    for r in out["allgather"]:
        assert [int(x[0]) for x in r] == [0, 1]


def test_reducescatter_sendrecv_barrier(outcomes):
    out = _value(outcomes, "collective_reducescatter_sendrecv_barrier")
    # sum = [1,3,5,7]; rank r gets chunk r (2 elems each)
    np.testing.assert_allclose(out["reducescatter"][0], [1.0, 3.0])
    np.testing.assert_allclose(out["reducescatter"][1], [5.0, 7.0])
    np.testing.assert_allclose(out["sendrecv"][1], [42.0])
    assert out["sendrecv"][0] is None
    assert all(out["barrier"])


def test_declarative_create_group(outcomes):
    """create_collective_group through the worker's hook on an actor
    class with no init method of its own."""
    out = _value(outcomes, "collective_declarative_create_group")
    for r in out["allreduce"]:
        np.testing.assert_allclose(r, np.full((4,), 3.0))
    assert out["info"] == [{"initialized": True, "rank": r, "size": 2}
                           for r in range(2)]


def test_destroy_leaves_only_final_barrier(outcomes):
    """Every op's keys are gone but the final barrier's markers, one per
    rank, which the JAX package also leaves on purpose."""
    keys = _value(outcomes,
                  "collective_destroy_leaves_only_final_barrier")["keys"]
    assert len(keys) == 2, keys
    ops = {k.split("/")[2] for k in keys}
    assert len(ops) == 1 and all(k.split("/")[3] == "barrier"
                                 for k in keys), keys
    assert sorted(k.rsplit("/", 1)[1] for k in keys) == ["0", "1"]


def test_host_plane_surface_matches_jax():
    """The port's module has the JAX host plane's names, keys and
    reducers, and leaves out the JAX device plane."""
    assert [op.value for op in tcol.ReduceOp] == \
        [op.value for op in jcol.ReduceOp]
    for name in ("init_collective_group", "create_collective_group",
                 "destroy_collective_group", "is_group_initialized",
                 "get_rank", "get_collective_group_size", "allreduce",
                 "barrier", "broadcast", "allgather", "reducescatter",
                 "send", "recv"):
        assert callable(getattr(tcol, name)), name
    assert not hasattr(tcol, "device_allreduce")
    assert tcol._key("g", "allreduce", 7, 1) == \
        jcol._key("g", "allreduce", 7, 1)
    xs = np.random.default_rng(0).standard_normal((3, 4)).astype(
        np.float32)
    for op in jcol.ReduceOp:
        np.testing.assert_array_equal(
            tcol._REDUCERS[tcol.ReduceOp(op.value)](xs),
            jcol._REDUCERS[op](xs))


def test_ungrouped_calls_raise():
    assert not tcol.is_group_initialized("nope")
    with pytest.raises(RuntimeError, match="not initialized"):
        tcol.get_rank("nope")
    with pytest.raises(ValueError, match="out of range"):
        tcol.init_collective_group(2, 2, group_name="nope")
    with pytest.raises(ValueError, match="must cover"):
        tcol.create_collective_group([object(), object()], 2, [0, 0])
