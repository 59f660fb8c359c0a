"""Twins of tests/test_state.py for the port (ray_tpu_torch): the state
API's nodes, workers, tasks (and their summary and failed status),
actors, objects and timeline, user metrics in Prometheus text (from the
driver and from a task), the cluster summary, metric misuse, and the
conductor's per-method RPC stats; and where the port differs: the
conductor's ring of recent worker log lines.

The cluster cases run in a driver process of their own
(`ray_tpu_torch._private.isolated.run_checks`): they are functions of
`ray_tpu_torch/_private/surface_checks.py`, each a case here, and
`__session_ended__` holds that every process of the run had exited.
The parity cases hand the same per-worker snapshots and task events to
both packages' renderers.
"""
from __future__ import annotations

import json
import random

import numpy as np
import pytest

from ray_tpu.util import state as jstate
from ray_tpu_torch._private import isolated
from ray_tpu_torch.util import state as tstate

CHECKS = {name: {"num_cpus": 4} for name in (
    "state_list_nodes_and_workers", "state_list_tasks_and_summary",
    "state_failed_task_status", "state_list_actors", "state_list_objects",
    "state_timeline_chrome_trace", "state_metrics_counter_gauge",
    "state_metrics_histogram", "state_metrics_in_worker",
    "state_cluster_summary", "state_invalid_metric_usage",
    "state_rpc_handler_stats", "port_state_recent_logs")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_state(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------------------ parity

def _tags(rng: random.Random, keys) -> str:
    return json.dumps([rng.choice(["/a", "/b", 'q"x', "l\nm", "s\\t"])
                       for _ in keys])


def _random_snapshots(rng: random.Random) -> dict:
    """Per-worker registry snapshots in the format util/metrics.py
    pushes: counters, gauges, untyped and histograms, tagged."""
    out = {}
    for w in range(rng.randint(1, 4)):
        snap = []
        for name, mtype in (("req_total", "counter"), ("depth", "gauge"),
                            ("misc", "untyped"), ("lat_s", "histogram")):
            if rng.random() < 0.25:
                continue
            keys = tuple(f"k{i}" for i in range(rng.randint(0, 2)))
            m = {"name": name, "type": mtype,
                 "description": rng.choice(["", "help text", 'a "q"']),
                 "tag_keys": keys}
            tag_sets = {_tags(rng, keys) for _ in range(rng.randint(1, 3))}
            if mtype == "histogram":
                bounds = sorted(rng.sample([0.001, 0.01, 0.1, 1.0, 10.0], 3))
                m["boundaries"] = bounds
                m["buckets"] = {t: [rng.randint(0, 9) for _ in range(4)]
                                for t in tag_sets}
                m["sums"] = {t: rng.random() * 10 for t in tag_sets}
                m["counts"] = {t: sum(m["buckets"][t]) for t in tag_sets}
            else:
                m["values"] = {t: rng.choice([1.0, 2.5, 7, rng.random()])
                               for t in tag_sets}
            snap.append(m)
        out["%032x" % rng.getrandbits(128)] = snap
    return out


@pytest.mark.parametrize("seed", range(6))
def test_render_prometheus_matches_jax(seed):
    per_worker = _random_snapshots(random.Random(seed))
    assert tstate._render_prometheus(per_worker) == \
        jstate._render_prometheus(per_worker)


def _random_events(rng: random.Random, n: int) -> list:
    out = []
    for i in range(n):
        start = 1.7e9 + rng.random() * 100
        out.append({"task_id": "%032x" % i,
                    "name": rng.choice(["f", "g", "abcd1234.m"]),
                    "start": start,
                    "end": start + rng.choice([0.0, rng.random(), -0.5]),
                    "worker": None, "job_id": "j",
                    "status": rng.choice(["FINISHED", "FAILED",
                                          "CANCELLED"])})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_summarize_tasks_matches_jax(seed, monkeypatch):
    events = _random_events(random.Random(seed), 50)
    monkeypatch.setattr(jstate, "list_tasks", lambda: list(events))
    monkeypatch.setattr(tstate, "list_tasks", lambda: list(events))
    got, want = tstate.summarize_tasks(), jstate.summarize_tasks()
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in ("count", "failed"):
            assert got[name][k] == want[name][k]
        for k in ("total_s", "min_s", "max_s", "mean_s"):
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       rtol=2e-4, atol=2e-5)
