"""The trainer's workers mode in the port (`TorchTrainer(mode="workers")`:
a gang of actor ranks, its process group, supervision, elastic re-form,
preemption grace and the chaos harness) against the JAX package's.

Twins of tests/test_train_gang.py's 2 cases and of the
tests/test_resilience.py cases that had none: `elastic_reform`, the
pending checkpoints' attempt-major order, chaos plans and the monkey,
the resilience timeline markers (each on the same inputs as the JAX
function, outputs compared), the chaos-scripted resume, and the two
cluster scenarios (the async grace checkpoint within its window; preempt,
quarantine and elastic restart). Cluster cases are checks of
`ray_tpu_torch/_private/fabric_checks.py`, each in a driver process of
its own (`_private/isolated.run_checks`, hard timeout 400 s). Where the
JAX tests sleep between steps so that the preemption notice lands before
the next one and the grace checkpoint before the kill, the port's
training functions wait, with a bound: rank 0 (which fires the
preemption) until every rank has started, every rank for the notice
after that step, and every rank at the kill's step for a checkpoint in
pending/. The port's own cases: a rank dying inside a collective, and
GPT-2 tiny trained by a 2-rank gloo gang (losses within 1e-5 of the one-process
step, a chaos kill restarting from pending/ onto the same last loss).
"""
from __future__ import annotations

import json
import os

import pytest

from ray_tpu.observability import timeline as jtimeline
from ray_tpu.resilience import chaos as jchaos
from ray_tpu.resilience import supervisor as jsup
from ray_tpu.train import checkpoint as jckpt
from ray_tpu.train import config as jconfig
from ray_tpu.train import trainer as jtrainer
from ray_tpu_torch._private import fabric_checks, isolated
from ray_tpu_torch.observability import timeline as ttimeline
from ray_tpu_torch.resilience import chaos as tchaos
from ray_tpu_torch.resilience import supervisor as tsup
from ray_tpu_torch.train import checkpoint as tckpt
from ray_tpu_torch.train import config as tconfig
from ray_tpu_torch.train import trainer as ttrainer

CLUSTER = {"num_cpus": 4}
CHECKS = {name: CLUSTER for name in (
    "gang_workers_mode_forms_gang_and_aggregates",
    "gang_workers_mode_opt_out",
    "gang_async_grace_checkpoint_commits_within_window",
    "port_gang_dead_rank_in_collective",
    "port_gang_gpt2_losses_and_chaos_restart")}
# tests/test_resilience.py's chaos_cluster: a 2-CPU head, a hair-trigger
# quarantine threshold (the check registers the 4-CPU "flaky-host")
CHECKS["gang_preempt_quarantine_elastic_restart_scenario"] = {
    "num_cpus": 2, "_system_config": {"quarantine_threshold": 1.0}}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=400.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_train_gang(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------------ elastic re-form

def _shape(out):
    if out is None:
        return None
    sc, sh = out
    return (sc.num_workers, sc.num_slices,
            None if sh is None else (sh.dcn_dp, sh.is_hybrid))


@pytest.mark.parametrize("case", [
    ("no_floor", dict(num_workers=4), None, 2),
    ("flat", dict(num_workers=4, min_workers=2), None, 3),
    ("below_floor", dict(num_workers=4, min_workers=2), None, 1),
    ("enough", dict(num_workers=4, min_workers=2), None, 4),
    ("slices", dict(num_workers=8, num_slices=4, min_workers=2),
     dict(dcn_dp=4), 5),
    ("one_slice", dict(num_workers=8, num_slices=4, min_workers=2),
     dict(dcn_dp=4), 3),
    ("other_dcn", dict(num_workers=8, num_slices=4, min_workers=2),
     dict(dcn_dp=2), 5)], ids=lambda c: c[0])
def test_elastic_reform_flat_and_multislice(case):
    _, scaling, sharding, avail = case
    got = tsup.elastic_reform(
        tconfig.ScalingConfig(**scaling),
        None if sharding is None else tconfig.ShardingConfig(**sharding),
        avail)
    want = jsup.elastic_reform(
        jconfig.ScalingConfig(**scaling),
        None if sharding is None else jconfig.ShardingConfig(**sharding),
        avail)
    assert _shape(got) == _shape(want)


def test_elastic_reform_examples():
    """tests/test_resilience.py's own assertions, on the port."""
    sc = tconfig.ScalingConfig(num_workers=4, min_workers=2)
    assert tsup.elastic_reform(tconfig.ScalingConfig(num_workers=4),
                               None, 2) is None
    assert tsup.elastic_reform(sc, None, 3)[0].num_workers == 3
    assert tsup.elastic_reform(sc, None, 1) is None
    sc = tconfig.ScalingConfig(num_workers=8, num_slices=4, min_workers=2)
    sh = tconfig.ShardingConfig(dcn_dp=4)
    new_sc, new_sh = tsup.elastic_reform(sc, sh, 5)
    assert (new_sc.num_workers, new_sc.num_slices, new_sh.dcn_dp) == \
        (4, 2, 2)
    new_sc, new_sh = tsup.elastic_reform(sc, sh, 3)
    assert (new_sc.num_workers, new_sc.num_slices) == (2, 1)
    assert new_sh.dcn_dp == 1 and not new_sh.is_hybrid


# --------------------------------------------- pending checkpoint order

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pending_checkpoints_sort_attempt_major(tmp_path, pkg):
    """A restart resets the report sequence: the newest pending
    checkpoint is picked attempt-major, in both packages alike."""
    trainer, ckpt = (ttrainer, tckpt) if pkg == "port" else \
        (jtrainer, jckpt)

    def make(attempt, seq):
        d = tmp_path / f"src-{attempt}-{seq}"
        d.mkdir()
        (d / "marker").write_text(f"{attempt}/{seq}")
        return trainer._persist_checkpoint(
            ckpt.Checkpoint(str(d)), str(tmp_path), rank=0, seq=seq,
            attempt=attempt)

    for seq in range(5):
        make(0, seq)
    out = make(1, 0)
    assert os.path.basename(out.path) == "0001-000000-rank0"
    newest = trainer._newest_pending_checkpoint(str(tmp_path))
    with open(os.path.join(newest.path, "marker")) as f:
        assert f.read() == "1/0"
    assert sorted(os.listdir(tmp_path / "pending")) == [
        "0000-000000-rank0", "0000-000001-rank0", "0000-000002-rank0",
        "0000-000003-rank0", "0000-000004-rank0", "0001-000000-rank0"]


# ------------------------------------------------------------ chaos

PLAN = [
    {"action": "kill", "rank": 1, "at_step": 5},
    {"action": "preempt", "node": "h1", "grace_s": 3, "at_step": 2},
    {"action": "delay_heartbeats", "ms": 250},
    {"action": "bounce_conductor", "at_step": 7},
    {"action": "raise", "rank": 0, "at_step": 4, "attempt": "any"},
    {"action": "delay_chunk_fetch", "ms": 40},
    {"action": "kill_replica", "role": "decode", "at": "token:4"},
]


def test_chaos_plan_parse_and_matching(tmp_path):
    spec = json.dumps(PLAN)
    plan, jplan = tchaos.ChaosPlan.from_spec(spec), \
        jchaos.ChaosPlan.from_spec(spec)
    assert [vars(a) for a in plan.actions] == \
        [vars(a) for a in jplan.actions]
    assert plan.heartbeat_delay_s() == pytest.approx(0.25) == \
        jplan.heartbeat_delay_s()
    assert plan.chunk_fetch_delay_s() == jplan.chunk_fetch_delay_s()
    p = tmp_path / "plan.json"
    p.write_text(spec)
    assert len(tchaos.ChaosPlan.from_spec(f"@{p}").actions) == len(PLAN)
    for step in range(1, 9):
        for rank in range(3):
            for attempt in range(2):
                assert [a.matches(step, rank, attempt)
                        for a in plan.actions] == \
                    [a.matches(step, rank, attempt) for a in jplan.actions]
    assert [a.action for a in plan.external_actions(7)] == \
        [a.action for a in jplan.external_actions(7)] == \
        ["bounce_conductor"]
    for bad in ([{"action": "meteor"}], [{"action": "kill"}],
                [{"action": "kill_replica", "role": "x", "at": "token:1"}]):
        with pytest.raises(ValueError):
            tchaos.ChaosPlan.from_spec(json.dumps(bad))
        with pytest.raises(ValueError):
            jchaos.ChaosPlan.from_spec(json.dumps(bad))
    assert not tchaos.ChaosPlan.from_spec(None)
    assert not tchaos.ChaosPlan.from_spec("")
    # a plan is an argument: the helpers take it, never the environment
    assert tchaos.heartbeat_delay_s(spec) == pytest.approx(0.25)
    assert tchaos.chunk_fetch_delay_s(plan) == pytest.approx(0.04)
    assert tchaos.heartbeat_delay_s(None) == 0.0
    assert tchaos.monkey_from_spec(None) is None


@pytest.mark.chaos
def test_chaos_monkey_fires_once_and_reports():
    calls, jcalls = [], []
    plan = [{"action": "raise", "rank": 0, "at_step": 3},
            {"action": "preempt", "node": "head", "grace_s": 2,
             "at_step": 2}]
    monkey = tchaos.ChaosMonkey(
        tchaos.ChaosPlan.from_spec(json.dumps(plan)), rank=0, attempt=0,
        conductor_call=lambda m, *a, **k: calls.append((m, a)))
    jmonkey = jchaos.ChaosMonkey(
        jchaos.ChaosPlan.from_spec(json.dumps(plan)), rank=0, attempt=0,
        conductor_call=lambda m, *a, **k: jcalls.append((m, a)))
    for m, err in ((monkey, tchaos.ChaosError),
                   (jmonkey, jchaos.ChaosError)):
        m.on_step(1)
        m.on_step(2)
        with pytest.raises(err):
            m.on_step(3)
        m.on_step(3)  # fired already: exactly once
    assert calls == jcalls
    assert [m for m, _ in calls] == ["report_resilience_event",
                                     "report_preemption",
                                     "report_resilience_event"]
    other = tchaos.ChaosMonkey(tchaos.ChaosPlan.from_spec(json.dumps(plan)),
                               rank=1, conductor_call=calls.append)
    other.on_step(3)  # a wrong rank never fires
    assert tchaos.monkey_from_spec(json.dumps(plan), rank=2).rank == 2


# ---------------------------------------------------- timeline markers

def test_resilience_timeline_markers():
    events = [{"kind": "preemption", "ts": 10.0, "node_id": "h1",
               "grace_s": 5.0},
              {"kind": "restart", "ts": 11.0, "name": "run",
               "attempt": 1},
              {"kind": "chaos", "ts": 10.5, "replica": 0},
              {"ts": None, "kind": "dropped"}]
    trace = ttimeline.resilience_trace_events(events)
    assert trace == jtimeline.resilience_trace_events(events)
    assert len(trace) == 3
    assert trace[0]["ph"] == "i" and trace[0]["cat"] == "resilience"
    assert trace[0]["name"] == "preemption:h1"
    assert trace[0]["args"]["grace_s"] == 5.0
    wev = [{"kind": "publish", "ts": 9.0, "name": "lm", "version": 2},
           {"kind": "swap", "ts": 12.0, "name": "lm", "version": 2}]
    assert ttimeline.weight_trace_events(wev) == \
        jtimeline.weight_trace_events(wev)
    merged = ttimeline.merged_chrome_trace([], [], [], events, wev)
    assert merged == jtimeline.merged_chrome_trace([], [], [], events, wev)
    assert {e["tid"] for e in merged} == {"preemption", "restart", "chaos",
                                          "publish", "swap"}
    # the span lane (ported with util/tracing.py) merges as JAX's does
    span = {"name": "task:f", "trace_id": "ab" * 16, "span_id": "cd" * 8,
            "parent_id": None, "start": 10.2, "end": 10.4, "attrs": {},
            "status": "OK", "pid": 7}
    merged = ttimeline.merged_chrome_trace([], [span], [], events, wev)
    assert merged == jtimeline.merged_chrome_trace([], [span], [], events,
                                                   wev)
    assert [e["cat"] for e in merged].count("span") == 1


# -------------------------------------------- chaos-scripted resume

@pytest.mark.chaos
def test_resume_matches_uninterrupted_run(tmp_path):
    """A chaos raise at step 4: the restart resumes from the step-4
    checkpoint and walks the uninterrupted trajectory exactly (the plan
    an argument of the trainer)."""
    from ray_tpu_torch.train import FailureConfig, RunConfig, TorchTrainer

    result = TorchTrainer(
        fabric_checks.sgd_train_fn,
        train_loop_config={"n_steps": fabric_checks.N_STEPS,
                           "checkpoint_every_step": True},
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)),
        chaos_plan=json.dumps([{"action": "raise", "rank": 0,
                                "at_step": 4}]),
        restart_backoff_base_s=0.01).fit()
    assert result.error is None
    expected = fabric_checks.expected_losses(fabric_checks.N_STEPS)
    steps = [m["step"] for m in result.metrics_history]
    assert steps == list(range(5, fabric_checks.N_STEPS + 1)), steps
    for m in result.metrics_history:
        assert m["loss"] == pytest.approx(expected[m["step"] - 1],
                                          rel=1e-12)


def test_chaos_plan_environment_is_not_read(tmp_path, monkeypatch):
    """The JAX package's RAY_TPU_CHAOS_PLAN changes nothing in the port:
    only the trainer's argument scripts faults."""
    from ray_tpu_torch.train import RunConfig, TorchTrainer

    monkeypatch.setenv("RAY_TPU_CHAOS_PLAN", json.dumps(
        [{"action": "raise", "rank": 0, "at_step": 1}]))
    result = TorchTrainer(
        fabric_checks.sgd_train_fn, train_loop_config={"n_steps": 3},
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None and result.metrics["step"] == 3


def test_rank_device_defaults_to_cuda():
    """A session's device is "cuda" unless the trainer set it, and a gang
    rank's bundle leases a GPU unless the caller passes use_gpu=False (as
    Ray's ScalingConfig does): only then does the rank compute on the CPU
    over gloo. A GPU asked for while use_gpu is False is refused."""
    from ray_tpu_torch.train import session as tsession

    assert tsession.TrainContext().device == "cuda"
    assert ttrainer._worker_bundle(tconfig.ScalingConfig(num_workers=2)) \
        == {"CPU": 1.0, "GPU": 1.0}
    assert ttrainer._worker_bundle(tconfig.ScalingConfig(
        num_workers=2, resources_per_worker={"CPU": 2, "GPU": 2})) \
        == {"CPU": 2, "GPU": 2}
    assert ttrainer._worker_bundle(tconfig.ScalingConfig(
        num_workers=2, use_gpu=False)) == {"CPU": 1.0}
    with pytest.raises(ValueError, match="use_gpu is False"):
        ttrainer._worker_bundle(tconfig.ScalingConfig(
            num_workers=2, use_gpu=False,
            resources_per_worker={"GPU": 1}))
