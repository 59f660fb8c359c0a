"""Twins of tests/test_profiling.py for the port (ray_tpu_torch), whose
util/profiling.py runs torch.profiler where the JAX package runs
jax.profiler: in-process traces with annotations, one profile at a
time, and remote capture on an actor's worker. Here there is no card,
so every profile passes `device="cpu"` (CPU ops only); without it a
process without CUDA raises, which `port_device_profile_refused_
without_cuda` holds on a worker.

The remote cases run in a driver process of their own
(`ray_tpu_torch._private.isolated.run_checks`): they are functions of
`ray_tpu_torch/_private/surface_checks.py`, each a case here, and
`__session_ended__` holds that every process of the run had exited.
"""
from __future__ import annotations

import glob
import json
import os

import pytest
import torch

from ray_tpu_torch._private import isolated
from ray_tpu_torch.util import profiling

CHECKS = {name: {"num_cpus": 2} for name in (
    "profile_actor_remote_capture",
    "port_device_profile_refused_without_cuda")}


def _has_trace_files(d):
    # the JAX twin's glob: a torch trace is a *.pt.trace.json
    return bool(glob.glob(os.path.join(d, "**", "*.trace.json*"),
                          recursive=True))


def test_profile_context_writes_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.profile(log_dir=d, device="cpu"):
        with profiling.annotate("matmul_block"):
            x = torch.ones((256, 256))
            torch.mm(x, x)
    assert _has_trace_files(d), os.listdir(d)
    (path,) = profiling.trace_files(d)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"matmul_block", "aten::mm"} <= names


def test_tracing_device_trace_is_a_profile(tmp_path):
    """util.tracing.device_trace, the device half of the tracing story,
    writes the same torch.profiler trace."""
    from ray_tpu_torch.util import tracing

    d = str(tmp_path / "dt")
    with tracing.device_trace(d, device="cpu"):
        x = torch.ones((64, 64))
        torch.mm(x, x)
    assert _has_trace_files(d), os.listdir(d)


def test_profile_double_start_rejected(tmp_path):
    d = str(tmp_path / "t")
    profiling.start_profile(log_dir=d, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiling.start_profile(log_dir=str(tmp_path / "t2"),
                                    device="cpu")
    finally:
        profiling.stop_profile()
    with pytest.raises(RuntimeError, match="no profile"):
        profiling.stop_profile()


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=240.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_profile_actor(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
