"""The step timer's conductor flush in the port (observability/
step_timer.py, observability/gang.py, the conductor's train-step ring
buffer, `util.state.train_progress`, the timeline's step markers)
against the JAX package's, on the CPU.

Twins of tests/test_observability.py's flight-recorder cases: the
straggler leg of test_train_run_flight_recorder (four ranks reported
through report_train_steps, rank 3 flagged) and a TorchTrainer (spmd)
run whose step records reach train_progress() and the merged timeline
with device_step_ms (the JAX test's JaxTrainer leg), each a check of
`_private/mpmd_checks.py` in a driver process of its own; and, in this
process, test_conductor_train_ring_buffers on both packages' conductor
handlers, `summarize_run` and the step markers against JAX's on the
same records, and the timer's batching.

Not twinned: that test's spans and MFU legs (util/tracing.py and the
CPU's unknown peak). Its CLI and dashboard legs
(test_train_status_cli_and_dashboard_route) are a check run by
tests/test_torch_dashboard.py.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from ray_tpu._private.conductor import ConductorHandler as JHandler
from ray_tpu.observability import gang as jgang
from ray_tpu.observability import step_timer as jtimer
from ray_tpu.observability import timeline as jtimeline
from ray_tpu_torch._private import isolated
from ray_tpu_torch._private.conductor import ConductorHandler as THandler
from ray_tpu_torch.observability import gang as tgang
from ray_tpu_torch.observability import step_timer as ttimer
from ray_tpu_torch.observability import timeline as ttimeline

CHECKS = {name: {"num_cpus": 4} for name in (
    "flight_straggler_gang", "flight_spmd_trainer_records")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


def _value(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
    return json.loads(text)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_flight_recorder_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_straggler_flagged(outcomes):
    out = _value(outcomes, "flight_straggler_gang")
    assert out["stragglers"] == [3] and out["max_over_median"] > 2.0


def test_trainer_step_records_reach_the_conductor(outcomes):
    out = _value(outcomes, "flight_spmd_trainer_records")
    assert out["run_id"].startswith("obs-accept/") and out["steps"] == 3
    assert len(out["device_step_ms"]) == 3
    assert all(v > 0 for v in out["device_step_ms"])


def _records(seed=0, ranks=4, steps=12):
    rng = np.random.default_rng(seed)
    out = {}
    for s in range(steps):
        out[s] = {}
        for r in range(ranks):
            ms = float(rng.uniform(80, 120)) * (2.4 if r == 2 else 1.0)
            out[s][r] = {"step": s, "rank": r, "total_ms": ms + 3.0,
                         "device_step_ms": ms, "data_wait_ms": 1.0,
                         "bubble_wait_ms": float(rng.uniform(0, 5)),
                         "t_start": 100.0 + s, "t_end": 100.0 + s + ms / 1e3,
                         "tokens": 512, "tokens_per_sec": 5e3}
    return out


def test_summarize_run_matches_jax():
    steps = _records()
    got = tgang.summarize_run(steps)
    assert got == jgang.summarize_run(steps, k=tgang.DEFAULT_STRAGGLER_K)
    assert got["stragglers"] == [2] and got["world"] == 4
    assert tgang.find_stragglers(steps, k=3.0) == []


def test_conductor_train_ring_buffers(tmp_path):
    """Per-run step window and run-count eviction are bounded, as in the
    JAX conductor; both handlers give the same progress and records."""
    th = THandler({"CPU": 2.0}, str(tmp_path / "t"))
    jh = JHandler({"CPU": 2.0}, str(tmp_path / "j"))
    recs = [{"step": s, "total_ms": 1.0, "t_start": 0.0, "t_end": 0.0}
            for s in range(1100)]
    for h in (th, jh):
        h.report_train_steps("big-run", 0, recs)
    assert len(th._train_runs["big-run"]["steps"]) == 1024
    assert min(th._train_runs["big-run"]["steps"]) == 1100 - 1024
    for i in range(20):
        for h in (th, jh):
            h.report_train_steps(f"run-{i}", 0,
                                 [{"step": 0, "total_ms": 1.0}])
    assert len(th._train_runs) <= th._TRAIN_RUNS_KEPT
    assert (th._TRAIN_STEPS_KEPT, th._TRAIN_RUNS_KEPT) == \
        (jh._TRAIN_STEPS_KEPT, jh._TRAIN_RUNS_KEPT)
    assert set(th._train_runs) == set(jh._train_runs)
    gang = _records(seed=1, ranks=3, steps=5)
    for h in (th, jh):
        for r in range(3):
            h.report_train_steps("gang", r, [gang[s][r] for s in gang])
    assert th.get_train_progress()["gang"] == \
        jh.get_train_progress()["gang"]
    assert th.get_train_steps(50) == jh.get_train_steps(50)


def test_step_markers_match_jax():
    """Step records become X markers under train:<run_id> / rank <r> with
    the phases (device_step_ms among them) in args, and counter events:
    JAX's events on the same records, merged the same way."""
    flat = [dict(rec, run_id="r/1") for by_rank in _records(
        seed=2, ranks=2, steps=3).values() for rec in by_rank.values()]
    flat.append({"step": 9, "rank": 0, "run_id": "r/1"})  # no times: skipped
    got = ttimeline.step_trace_events(flat)
    assert got == jtimeline.step_trace_events(flat)
    marks = [e for e in got if e["ph"] == "X"]
    assert len(marks) == 6 and {e["tid"] for e in marks} == {"rank 0",
                                                             "rank 1"}
    assert all(e["args"]["device_step_ms"] > 0 for e in marks)
    assert all(e["pid"] == "train:r/1" for e in got)
    merged = ttimeline.merged_chrome_trace([], [], flat)
    assert merged == jtimeline.merged_chrome_trace([], [], flat)


def test_pipeline_markers_match_jax():
    events = [{"kind": "open", "pipeline": "p", "ts": 1.0,
               "num_stages": 2},
              {"kind": "stage_report", "pipeline": "p", "stage": 1,
               "ts": 2.0, "sent_bytes": 10, "bubble_fraction": 0.2},
              {"kind": "stage_death", "pipeline": "p", "ts": 3.0},
              {"kind": "dropped", "ts": None}]
    got = ttimeline.pipeline_trace_events(events)
    assert got == jtimeline.pipeline_trace_events(events)
    assert [e["tid"] for e in got] == ["open", "stage 1", "stage_death"]
    merged = ttimeline.merged_chrome_trace([], [], [],
                                           pipeline_events=events)
    assert merged == jtimeline.merged_chrome_trace([], [], [],
                                                   pipeline_events=events)


def test_step_timer_records_match_jax_and_batch():
    """The record carries JAX's keys; without a cluster the flush keeps
    the records buffered (the newest _PENDING_CAP), with JAX's cadence
    constants; close() drops a step still open."""
    assert (ttimer._FLUSH_EVERY, ttimer._FLUSH_INTERVAL_S,
            ttimer._PENDING_CAP) == (jtimer._FLUSH_EVERY,
                                     jtimer._FLUSH_INTERVAL_S,
                                     jtimer._PENDING_CAP)
    t = ttimer.StepTimer("run/x", rank=3, world_size=4)
    j = jtimer.StepTimer("run/x", rank=3, world_size=4, enabled=True)
    for timer in (t, j):
        timer.record("bubble_wait", 0.01)
        timer.record("device_step", 0.02)
    trec, jrec = t.end_step(), j.end_step()
    assert set(trec) == set(jrec)
    assert trec["rank"] == 3 and trec["t_end"] >= trec["t_start"]
    assert trec["bubble_wait_ms"] == pytest.approx(10.0)
    for _ in range(20):
        t.record("device_step", 0.0)
        t.end_step()
    assert len(t._pending) == 21 and len(t.records) == 21
    t.ensure_step_open()
    t.close()
    assert len(t._pending) == 21 and t.end_step() is None
