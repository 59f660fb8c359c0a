"""Twins of tests/test_tracing.py for the port (ray_tpu_torch): span
recording, W3C propagation across task and actor hops, the conductor's
span cap, chrome-trace and OTLP export; and where the port differs: the
switch is `tracing.enable()` in the driver (RTT_TRACING for workers it
spawns, the traceparent on the wire for the rest), and spans reach the
merged timeline's span lane.

The cluster cases run in a driver process of their own
(`ray_tpu_torch._private.isolated.run_checks`): they are functions of
`ray_tpu_torch/_private/surface_checks.py`, each a case here, and
`__session_ended__` holds that every process of the run had exited.
The in-process cases and the parity cases (the same span lists through
both packages' exporters) run here.
"""
from __future__ import annotations

import random
import time

import pytest

from ray_tpu.util import tracing as jtracing
from ray_tpu_torch._private import isolated
from ray_tpu_torch.util import tracing

CHECKS = {
    "tracing_spans_cross_task_boundary": {"num_cpus": 2},
    "tracing_spans_cross_actor_boundary": {"num_cpus": 2},
    "tracing_conductor_span_buffer_capped": None,
    "port_tracing_spans_in_merged_timeline": {"num_cpus": 2},
}


@pytest.fixture(autouse=True)
def clean_tracing(monkeypatch):
    monkeypatch.delenv(tracing.ENV_TRACING, raising=False)
    tracing._enabled = False
    tracing._finished.clear()
    yield
    tracing._enabled = False
    tracing._finished.clear()


def test_disabled_is_free():
    with tracing.span("noop") as s:
        assert s is None
    assert tracing.drain() == []


def test_span_nesting_and_drain():
    tracing.enable()
    with tracing.span("outer", job="j1") as outer:
        with tracing.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
    spans = tracing.drain()
    assert [s["name"] for s in spans] == ["inner", "outer"]
    assert spans[1]["attrs"] == {"job": "j1"}
    assert all(s["end"] >= s["start"] for s in spans)
    assert tracing.drain() == []


def test_error_status_recorded():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("boom"):
            raise ValueError("x")
    (s,) = tracing.drain()
    assert s["status"] == "ERROR: ValueError"


def test_traceparent_roundtrip():
    tracing.enable()
    with tracing.span("parent") as p:
        tp = tracing.current_traceparent()
        assert tp == p.traceparent()
    # a "remote" span built from the wire value joins the same trace
    with tracing.span("remote-child", traceparent=tp) as c:
        assert c.trace_id == p.trace_id
        assert c.parent_id == p.span_id


def test_exports():
    tracing.enable()
    with tracing.span("work", k="v"):
        time.sleep(0.01)
    spans = tracing.drain()
    trace = tracing.to_chrome_trace(spans)
    assert trace[0]["name"] == "work" and trace[0]["ph"] == "X"
    assert trace[0]["dur"] > 0
    otlp = tracing.to_otlp_json(spans)
    os_spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert os_spans[0]["name"] == "work"
    assert os_spans[0]["status"]["code"] == 1


def test_otlp_error_detail_carried():
    """to_otlp_json must not collapse failures to a bare code=2: the
    recorded `ERROR: <type>` detail rides as status.message."""
    tracing.enable()
    with pytest.raises(KeyError):
        with tracing.span("fails"):
            raise KeyError("missing")
    otlp = tracing.to_otlp_json(tracing.drain())
    (sp,) = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert sp["status"] == {"code": 2, "message": "KeyError"}
    # OK spans carry no message
    with tracing.span("fine"):
        pass
    otlp = tracing.to_otlp_json(tracing.drain())
    (sp,) = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert sp["status"] == {"code": 1}


def test_enable_sets_the_spawn_wiring(monkeypatch):
    """The switch reaches spawned workers through RTT_TRACING (never a
    RAY_TPU_* variable)."""
    import os

    monkeypatch.delenv("RAY_TPU_TRACING", raising=False)
    tracing.enable()
    assert os.environ[tracing.ENV_TRACING] == "1"
    assert "RAY_TPU_TRACING" not in os.environ
    assert tracing.ENV_TRACING.startswith("RTT_")


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=240.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_spans_in_a_cluster(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------------------ parity

def _random_spans(rng: random.Random, n: int) -> list:
    statuses = ["OK", "ERROR: ValueError", "ERROR: KeyError", "CANCELLED"]
    out = []
    for i in range(n):
        start = 1.7e9 + rng.random() * 1e4
        out.append({
            "name": rng.choice(["task:f", "actor:T.m", "submit:f", "root"]),
            "trace_id": "%032x" % rng.getrandbits(128),
            "span_id": "%016x" % rng.getrandbits(64),
            "parent_id": rng.choice([None, "%016x" % rng.getrandbits(64)]),
            "start": start,
            "end": rng.choice([None, start + rng.random() * 2.0]),
            "attrs": {f"k{j}": rng.choice(["v", 3, 2.5, True])
                      for j in range(rng.randint(0, 3))},
            "status": rng.choice(statuses),
            "pid": rng.randint(1, 1 << 20),
        })
    return out


_NAMES = {"ray_tpu_torch": "ray_tpu",
          "ray_tpu_torch.util.tracing": "ray_tpu.util.tracing"}


def _as_jax_names(otlp: dict) -> dict:
    """The port's export with its service and scope names in the JAX
    package's (the one intended difference)."""
    for rs in otlp["resourceSpans"]:
        for a in rs["resource"]["attributes"]:
            v = a["value"]["stringValue"]
            a["value"]["stringValue"] = _NAMES.get(v, v)
        for ss in rs["scopeSpans"]:
            ss["scope"]["name"] = _NAMES.get(ss["scope"]["name"],
                                             ss["scope"]["name"])
    return otlp


@pytest.mark.parametrize("seed", range(4))
def test_exports_match_jax(seed):
    spans = _random_spans(random.Random(seed), 30)
    assert tracing.to_chrome_trace(spans) == jtracing.to_chrome_trace(spans)
    assert _as_jax_names(tracing.to_otlp_json(spans)) == \
        jtracing.to_otlp_json(spans)


def test_parse_traceparent_matches_jax():
    rng = random.Random(11)
    values = ["", "-", "00-abc-def-01", "00-a-b", "00-a-b-c-d",
              "00-" + "0" * 32 + "-" + "0" * 16 + "-01"]
    for _ in range(200):
        parts = ["%x" % rng.getrandbits(rng.randint(0, 128))
                 for _ in range(rng.randint(0, 6))]
        values.append("-".join(parts))
    for v in values:
        assert tracing._parse_traceparent(v) == \
            jtracing._parse_traceparent(v), v
