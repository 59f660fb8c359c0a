"""Twins of tests/test_perf_suite.py for the port (ray_tpu_torch): every
bench of `_private/perf.py` runs end to end at a tiny scale and emits
well-formed records; pipelined tasks keep at least 0.6 of the serial
rate; actor churn keeps at least 10 actors/s (the JAX twins' bounds).

The cases run in a driver process of their own
(`ray_tpu_torch._private.isolated.run_checks`): they are functions of
`ray_tpu_torch/_private/surface_checks.py`, each a case here, and
`__session_ended__` holds that every process of the run had exited.
`_latency_stats` is held to the JAX package's on the same samples.
"""
from __future__ import annotations

import numpy as np
import pytest

from ray_tpu._private import perf as jperf
from ray_tpu_torch._private import isolated
from ray_tpu_torch._private import perf as tperf

CHECKS = {name: None for name in (
    "perf_microbench_smoke", "perf_pipelined_tasks_not_inverted",
    "perf_actor_churn_floor")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_perf_suite(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


@pytest.mark.parametrize("seed", range(4))
def test_latency_stats_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    samples = [float(x) for x in rng.lognormal(-7.0, 1.0, n)]
    got, want = tperf._latency_stats(samples), jperf._latency_stats(samples)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5)


def test_benches_match_jax():
    assert [b.__name__ for b in tperf.BENCHES] == \
        [b.__name__ for b in jperf.BENCHES]
