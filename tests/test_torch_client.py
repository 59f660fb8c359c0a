"""Twins of tests/test_ray_client.py for the port (ray_tpu_torch): a
separate process connects with `init(address="ray://host:port")` through
a `ClientProxy` and drives tasks, actors, puts, waits and conductor
queries; a session's pins go with its disconnect. And where the port
differs: a client holds no GPU lease, so its `get` of a CUDA tensor's
record raises GpuLeaseRequiredError naming the object, with
`torch.cuda.is_available()` made to answer True in the client as the
CPU stand-in for a machine with a card.

The cases run in a driver process of their own
(`ray_tpu_torch._private.isolated.run_checks`): they are functions of
`ray_tpu_torch/_private/surface_checks.py`, each a case here, and
`__session_ended__` holds that every process of the run had exited.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import isolated

CHECKS = {name: {"num_cpus": 4} for name in (
    "client_end_to_end", "client_session_pins_released_on_disconnect",
    "port_client_cuda_get_refused")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=240.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_client(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
