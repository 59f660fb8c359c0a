"""The cluster layer's pure-Python parts in the port (ray_tpu_torch)
against the JAX package's, on the same inputs: the failure-domain
tracker on the same event sequences under an injected clock, the
maintenance-event parser and watcher on the same files, the log
tailer and its line format on the same log files, and the memory
monitor's threshold and victim choice with the same injected readers.
Nothing here starts a cluster or a process; the runtime's checks run
in isolated drivers (tests/test_torch_runtime_*.py).
"""
from __future__ import annotations

import json
import os

import pytest

from ray_tpu._private import log_monitor as jlog
from ray_tpu._private import memory_monitor as jmem
from ray_tpu.resilience import domains as jdomains
from ray_tpu.resilience import preemption as jpre
from ray_tpu_torch._private import log_monitor as tlog
from ray_tpu_torch._private import memory_monitor as tmem
from ray_tpu_torch.resilience import domains as tdomains
from ray_tpu_torch.resilience import preemption as tpre

# (clock, op, domain, argument) steps; each op is a tracker method
TRACKER_SEQUENCES = {
    "decay_and_hysteresis": (
        dict(threshold=2.0, half_life_s=10.0, exempt=("head",)),
        [(0.0, "record", "h1", "worker_death"),
         (1.0, "record", "h1", "oom"),
         (10.0, "probe", "h1", None),
         (14.9, "probe", "h1", None),
         (21.5, "probe", "h1", None),
         (22.0, "record", "h1", "worker_death"),
         (22.0, "record", "h1", "worker_death"),
         (23.0, "record", "head", "worker_death"),
         (23.0, "record", "head", "worker_death"),
         (23.0, "record", "head", "worker_death"),
         (24.0, "probe", "head", None)]),
    "drains_extend_never_shorten": (
        dict(threshold=3.0, half_life_s=60.0),
        [(0.0, "drain", "h1", 5.0),
         (1.0, "drain", "h1", 3.0),
         (4.0, "probe", "h1", None),
         (5.5, "probe", "h1", None),
         (6.0, "drain", "h2", 9.0),
         (6.0, "record", "h2", "worker_death"),
         (8.0, "probe", "h2", None),
         (9.5, "probe", "h2", None)]),
    "manual_pin_and_clear": (
        dict(threshold=1.0, half_life_s=5.0, exempt=("head",)),
        [(0.0, "quarantine", "head", "operator"),
         (0.0, "quarantine", "h3", "operator"),
         (50.0, "probe", "h3", None),
         (50.0, "probe", "head", None),
         (51.0, "clear", "head", None),
         (51.0, "record", "h4", "crash"),
         (52.0, "probe", "h4", None),
         (60.0, "clear", "h3", None),
         (60.0, "probe", "h3", None)]),
}


def _drive_tracker(mod, kwargs, steps):
    clock = [0.0]
    t = mod.FailureDomainTracker(clock=lambda: clock[0], **kwargs)
    seen = []
    for now, op, domain, arg in steps:
        clock[0] = now
        if op == "record":
            seen.append(round(t.record(domain, arg, detail=f"d{now}"), 12))
        elif op == "drain":
            t.begin_drain(domain, deadline=arg, reason="preemption")
        elif op == "quarantine":
            t.quarantine(domain, arg)
        elif op == "clear":
            seen.append(t.clear(domain))
        seen.append((round(t.score(domain), 12), t.is_quarantined(domain),
                     t.is_draining(domain), t.is_excluded(domain),
                     sorted(t.excluded()), t.trip_count(domain),
                     t.trip_count()))
    status = t.status()
    for st in status["domains"].values():
        for event in st["recent"]:
            event.pop("ts")  # wall clock
        st.pop("last_failure_ts")
    return seen, status


@pytest.mark.parametrize("name", sorted(TRACKER_SEQUENCES))
def test_failure_domain_tracker_matches_jax(name):
    kwargs, steps = TRACKER_SEQUENCES[name]
    assert _drive_tracker(tdomains, kwargs, steps) == \
        _drive_tracker(jdomains, kwargs, steps)


MAINTENANCE_FILES = {
    "missing": None,
    "empty": "",
    "grace_and_reason": json.dumps({"grace_s": 7.5,
                                    "reason": "spot-reclaim"}),
    "grace_only": json.dumps({"grace_s": 12}),
    "bad_grace": json.dumps({"grace_s": "soon", "reason": "x"}),
    "malformed": "{not json",
    "not_a_dict": json.dumps([1, 2]),
}


def _event_fields(ev):
    return None if ev is None else (ev.grace_s, ev.reason, ev.raw)


@pytest.mark.parametrize("name", sorted(MAINTENANCE_FILES))
def test_maintenance_event_parser_matches_jax(tmp_path, name):
    spec = str(tmp_path / "maint.json")
    if MAINTENANCE_FILES[name] is not None:
        with open(spec, "w") as f:
            f.write(MAINTENANCE_FILES[name])
    assert _event_fields(tpre.read_maintenance_event(spec)) == \
        _event_fields(jpre.read_maintenance_event(spec))


def test_maintenance_event_without_channel_is_none():
    """No file named: no event, whatever the environment says (the JAX
    package reads RAY_TPU_MAINTENANCE_EVENT; the port takes the path as
    an argument)."""
    assert tpre.read_maintenance_event(None) is None
    assert tpre.read_maintenance_event("") is None


def test_preemption_watcher_fires_like_jax(tmp_path):
    spec = str(tmp_path / "maint.json")
    fired = {"jax": [], "port": []}
    watchers = {"jax": jpre.PreemptionWatcher(fired["jax"].append, spec=spec),
                "port": tpre.PreemptionWatcher(fired["port"].append,
                                               spec=spec)}

    def poll():
        return {k: _event_fields(w.poll_once()) for k, w in watchers.items()}

    steps = []
    steps.append(poll())
    with open(spec, "w") as f:
        json.dump({"grace_s": 3.0, "reason": "maintenance"}, f)
    steps += [poll(), poll()]
    os.unlink(spec)
    steps.append(poll())
    open(spec, "w").close()
    steps += [poll(), poll()]
    for step in steps:
        assert step["jax"] == step["port"], steps
    assert [_event_fields(e) for e in fired["jax"]] == \
        [_event_fields(e) for e in fired["port"]]
    assert len(fired["port"]) == 2


@pytest.mark.parametrize("entry", [
    {"worker": "ab12", "node": "head", "line": "hi"},
    {"worker": "ab12", "node": "", "line": "no node"},
    {"line": "no worker"},
    {"worker": "w", "node": "n"},
], ids=["full", "empty_node", "no_worker", "no_line"])
def test_format_log_line_matches_jax(entry):
    assert tlog.format_log_line(entry) == jlog.format_log_line(entry)


def test_log_tailer_matches_jax(tmp_path):
    """Both tailers read the same growing, truncated and over-full logs
    tick by tick and publish the same lines."""
    cap = tlog._MAX_LINES_PER_TICK
    assert cap == jlog._MAX_LINES_PER_TICK
    assert tlog._MAX_LINE == jlog._MAX_LINE
    a, b = tmp_path / "worker-aaa.log", tmp_path / "worker-bbb.log"
    port = tlog.LogMonitor(str(tmp_path), lambda batch: None, node_label="n")
    jax = jlog.LogMonitor(str(tmp_path), lambda batch: None, node_label="n")
    writes = [
        (a, "wb", b"one\ntwo\nthr"),
        (b, "wb", b"x" * (tlog._MAX_LINE + 10) + b"\n\n  \nend\n"),
        (a, "ab", b"ee\n"),
        (a, "wb", b"rotated\n"),
        (b, "ab", b"".join(b"burst-%d\n" % i for i in range(cap + 30))),
        (a, "ab", b"tail"),
        (a, "ab", b"-done\n"),
    ]
    for path, mode, data in writes:
        with open(path, mode) as f:
            f.write(data)
        for _ in range(2):
            assert port.poll_once() == jax.poll_once()


MEMORY_CASES = {
    "over": (0.9, (95, 100)),
    "under": (0.9, (50, 100)),
    "at": (0.5, (50, 100)),
    "disabled": (0.0, (100, 100)),
    "no_total": (0.5, (10, 0)),
}


@pytest.mark.parametrize("name", sorted(MEMORY_CASES))
def test_memory_threshold_matches_jax(name):
    threshold, usage = MEMORY_CASES[name]
    assert tmem.MemoryMonitor(threshold, usage_fn=lambda: usage
                              ).over_threshold() == \
        jmem.MemoryMonitor(threshold, usage_fn=lambda: usage
                           ).over_threshold()


VICTIM_CASES = {
    "busy_first": [("w1", 1, "BUSY"), ("w2", 2, "BUSY"), ("w3", 3, "ACTOR"),
                   ("w4", 4, "ACTOR")],
    "actors_then_idle": [("w3", 3, "ACTOR"), ("w4", 4, "ACTOR"),
                         ("w5", 5, "IDLE")],
    "idle_only": [("w5", 5, "IDLE"), ("w6", 6, "IDLE")],
    "unknown_states": [("w7", 7, "STARTING"), ("w8", 8, "DEAD"),
                       ("w1", 1, "IDLE")],
    "dead_pids": [("w9", 9, "BUSY"), ("w0", None, "BUSY")],
    "ties": [("wa", 10, "BUSY"), ("wb", 11, "BUSY")],
    "empty": [],
}
RSS = {1: 100, 2: 900, 3: 500, 4: 5000, 5: 7000, 6: 10, 7: 1 << 30,
       8: 1 << 31, 10: 300, 11: 300}


@pytest.mark.parametrize("name", sorted(VICTIM_CASES))
def test_memory_victim_matches_jax(name):
    workers = VICTIM_CASES[name]
    got = tmem.MemoryMonitor(0.9, rss_fn=lambda pid: RSS.get(pid, 0)
                             ).pick_victim(workers)
    want = jmem.MemoryMonitor(0.9, rss_fn=lambda pid: RSS.get(pid, 0)
                              ).pick_victim(workers)
    assert got == want
