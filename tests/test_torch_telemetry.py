"""The serving plane's Prometheus families in the port (ray_tpu_torch)
against the JAX package's, on the CPU.

Every counter family of the serving plane and its neighbours is a
`util.metrics` family with the JAX package's name, help string, tag keys,
type and buckets, letter for letter: shed, disagg, servefault, kvplane,
autoscale, online, pipeline, weights, kvcache, spec, lora, reqtrace and
gateway (each group a case here). Each is created on first use: importing the
modules starts no metrics pusher. A cluster case (`_private/
telemetry_checks.py`, in a driver process of its own) gives every family
one probe sample and finds each by name, with that sample, in the
driver's `util.state.prometheus_metrics()`.
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from ray_tpu_torch._private import isolated, telemetry_checks


def _jax_families():
    from ray_tpu.models.engine import spec_metrics
    from ray_tpu.models.kvcache import kvcache_metrics
    from ray_tpu.mpmd.metrics import pipeline_metrics
    from ray_tpu.observability.requests import reqtrace_metrics
    from ray_tpu.online.metrics import online_metrics
    from ray_tpu.serve.autoscale import autoscale_metrics
    from ray_tpu.serve.disagg import disagg_metrics, servefault_metrics
    from ray_tpu.serve.handle import shed_counter
    from ray_tpu.serve.kvplane import kvplane_metrics
    from ray_tpu.serve.lora import lora_metrics
    from ray_tpu.serve.qos import gateway_metrics
    from ray_tpu.weights.metrics import weight_metrics

    return {"shed": {"shed": shed_counter()}, "disagg": disagg_metrics(),
            "servefault": servefault_metrics(),
            "kvplane": kvplane_metrics(),
            "autoscale": autoscale_metrics(), "online": online_metrics(),
            "pipeline": pipeline_metrics(), "weights": weight_metrics(),
            "kvcache": kvcache_metrics(), "spec": spec_metrics(),
            "lora": lora_metrics(), "reqtrace": reqtrace_metrics(),
            "gateway": gateway_metrics()}


GROUPS = ["shed", "disagg", "servefault", "kvplane", "autoscale", "online",
          "pipeline", "weights", "kvcache", "spec", "lora", "reqtrace",
          "gateway"]


def _shape(m):
    return (m.name, m.description, tuple(m._tag_keys), m._type,
            list(getattr(m, "boundaries", []) or []))


@pytest.mark.parametrize("group", GROUPS)
def test_family_matches_jax(group):
    mine = telemetry_checks._families()[group]
    theirs = _jax_families()[group]
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        assert _shape(mine[key]) == _shape(theirs[key]), key


def test_families_are_made_on_first_use():
    """Importing every module that owns a family starts no pusher."""
    code = (
        "import threading\n"
        "import ray_tpu_torch.models.engine, ray_tpu_torch.models.kvcache\n"
        "import ray_tpu_torch.mpmd, ray_tpu_torch.online\n"
        "import ray_tpu_torch.observability.requests\n"
        "import ray_tpu_torch.serve.autoscale, ray_tpu_torch.serve.disagg\n"
        "import ray_tpu_torch.serve.handle, ray_tpu_torch.serve.kvplane\n"
        "import ray_tpu_torch.serve.lora, ray_tpu_torch.weights\n"
        "import ray_tpu_torch.serve.qos, ray_tpu_torch.serve.gateway\n"
        "from ray_tpu_torch.util import metrics\n"
        "print(len(metrics._registry._metrics),"
        " [t.name for t in threading.enumerate()])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
    assert "metrics-push" not in out.stdout, out.stdout


def test_no_private_counter_is_left():
    from ray_tpu_torch.serve import handle

    assert not hasattr(handle, "Counter") and not hasattr(handle, "Gauge")


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(
        {"port_every_family_reaches_prometheus": {"num_cpus": 2}},
        timeout=200.0)


def test_every_family_reaches_prometheus(outcomes):
    ok, text = outcomes["port_every_family_reaches_prometheus"]
    assert ok, text
    found = json.loads(text)
    want = {g: sorted(m.name for m in fam.values())
            for g, fam in _jax_families().items()}
    assert found == want


def test_family_session_ended(outcomes):
    ok, text = outcomes[isolated.SESSION_ENDED]
    assert ok, text
