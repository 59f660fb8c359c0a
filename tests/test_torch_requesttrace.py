"""Twins of tests/test_requesttrace.py for the port's request flight
recorder (ray_tpu_torch/observability/requests.py) and its hooks in
`serve/disagg.py`, on the CPU, with Llama tiny fp32 carried over from
JAX by `from_jax_params`.

The trace object, tail retention and p99 attribution run here on both
packages; the store's arguments replace the JAX test's `monkeypatch` of
the ``RAY_TPU_REQTRACE_*`` knobs. The router cases drive in-process
tiers (no cluster). Parity cases feed the same summaries to both
packages' `p99_attribution`, the same finished traces to both stores
with `sample` 0 and 1 (so the draw decides nothing) and compare the kept
sets and stats, hand both packages' conductor handlers the same kvcache,
speculation, LoRA and request-trace reports and events, and hold each
new timeline lane (kvcache, speculation, lora, requests) equal to JAX's
on the same events.

The cluster cases are checks of `_private/telemetry_checks.py`, each in
a driver process of its own (`isolated.run_checks`): the one set of
numbers (state view, request_trace by id, the ``ray_tpu_reqtrace_*``
Prometheus families, the timeline's requests lane), the remote child
phase merged into a kept trace, the chunk-delay chaos case (the slow
decode replica's ``chaos=`` in place of the JAX test's environment
variable), and a decode actor's remote phase and disagg counters
crossing its process (`port_*`).

The gateway cases drive the port's `GatewayServer` over real sockets:
the incoming traceparent and the X-Request-Id header, the header on
errors and streams, the stream's ``sse_flush`` phase, and a preempted
stream's replay under one id (its interactive request sent once the batch
stream's first SSE frame has been read, not after a sleep).

The CLI and dashboard legs of test_all_surfaces_report_one_set_of_
numbers (`requests --json`, `requests --trace ID` and
`/api/requesttrace`) are in its check.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private.conductor import ConductorHandler as JHandler
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import llama_init as jllama_init
from ray_tpu.observability import requests as jreq
from ray_tpu.observability import timeline as jtimeline
from ray_tpu.serve import disagg as jdisagg
from ray_tpu_torch._private import isolated
from ray_tpu_torch._private.conductor import ConductorHandler as THandler
from ray_tpu_torch._private.serve_checks import FlakyDecode
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.observability import requests as reqtrace
from ray_tpu_torch.observability import timeline as ttimeline
from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                        PrefillServer)
from ray_tpu_torch.serve.gateway import GatewayServer
from ray_tpu_torch.serve.handle import RequestShedError
from ray_tpu_torch.serve.qos import QosGate

JCFG = dataclasses.replace(JLlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
BS = 4
C4 = {"num_cpus": 4, "_system_config": {"log_to_driver": 0}}

CHECKS = {name: C4 for name in (
    "requesttrace_all_surfaces_report_one_set_of_numbers",
    "requesttrace_remote_child_phases_merge_into_the_kept_trace",
    "requesttrace_chaos_chunk_delay_makes_kv_transfer_the_tail_owner",
    "port_actor_decode_telemetry_crosses_its_process")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_requesttrace_cluster(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


@pytest.fixture(scope="module")
def model():
    jp = jllama_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(autouse=True)
def fresh_store():
    """Each case starts from empty process stores, in both packages."""
    from ray_tpu.util import envknobs

    reqtrace._reset_store_for_tests()
    jreq._reset_store_for_tests()
    envknobs.clear()
    yield
    reqtrace._reset_store_for_tests()
    jreq._reset_store_for_tests()
    envknobs.clear()


def _mk_record(rid, total_ms, outcome="ok", replayed=False, preempts=0,
               phase_ms=None):
    """A finished-trace record shaped like RequestTrace.finish()."""
    return {"kind": "trace", "request_id": rid, "trace_id": "0" * 32,
            "source": "test", "ts": 1000.0, "total_ms": float(total_ms),
            "outcome": outcome, "attempts": 2 if replayed else 1,
            "replayed": replayed, "preempts": preempts, "phases": [],
            "phase_ms": dict(phase_ms or {})}


# ------------------------------------------------------- trace object

def test_phase_sum_approximates_wall_time():
    tr = reqtrace.RequestTrace("r-sum")
    with tr.phase("prefill"):
        time.sleep(0.03)
    with tr.phase("kv_transfer"):
        time.sleep(0.02)
    with tr.phase("decode_steady"):
        time.sleep(0.01)
    tr.add_phase("sse_flush", 500.0)  # concurrent: out of the sum
    rec = tr.finish("ok")
    seq_ms = sum(p["dur_ms"] for p in rec["phases"]
                 if not p.get("concurrent"))
    assert rec["phase_ms"]["prefill"] >= 25.0
    assert rec["phase_ms"]["kv_transfer"] >= 15.0
    assert seq_ms <= rec["total_ms"] + 5.0, rec
    assert rec["phase_ms"]["sse_flush"] == 500.0
    conc = [p for p in rec["phases"] if p["phase"] == "sse_flush"]
    assert conc and conc[0]["concurrent"] is True


def test_annotate_accumulates_on_open_phase():
    tr = reqtrace.RequestTrace("r-ann")
    with tr.phase("kv_transfer"):
        tr.annotate(pull_ms=10.0, pulls=1)
        tr.annotate(pull_ms=5.5, pulls=1, server="d0")
    rec = tr.finish("ok")
    ph = next(p for p in rec["phases"] if p["phase"] == "kv_transfer")
    assert ph["pull_ms"] == 15.5 and ph["pulls"] == 2
    assert ph["server"] == "d0"


def test_finish_is_idempotent_first_wins():
    tr = reqtrace.RequestTrace("r-idem")
    first = tr.finish("disconnect", cause="client_gone")
    assert tr.finish("ok") is first
    assert first["outcome"] == "disconnect"


def test_replays_and_preempts_nest_under_one_id():
    store = reqtrace.RequestTraceStore()
    tr = reqtrace.RequestTrace("r-replay", store=store)
    with pytest.raises(ConnectionError):
        with tr.phase("prefill"):
            raise ConnectionError("replica died")
    tr.begin_attempt()
    with tr.phase("prefill"):
        pass
    with tr.phase("kv_transfer"):
        pass
    tr.mark_preempt()
    with tr.phase("decode_steady"):
        pass
    rec = tr.finish("ok")
    assert rec["attempts"] == 3 and rec["replayed"] is True
    assert rec["preempts"] == 1
    assert [p["attempt"] for p in rec["phases"]] == [1, 2, 2, 3]
    assert rec["phases"][0]["error"] == "ConnectionError"
    assert store.trace("r-replay") is not None  # replayed: kept


# ------------------------------------------------------ tail retention

def test_tail_retention_keeps_anomalies_and_slowest():
    store = reqtrace.RequestTraceStore(sample=0.0, slowest=2, kept=32)
    store.record(_mk_record("slow-1", 900.0))
    store.record(_mk_record("slow-2", 800.0))
    for i, outcome in enumerate(sorted(reqtrace.ANOMALOUS_OUTCOMES)):
        store.record(_mk_record(f"anom-{outcome}", 1.0 + i,
                                outcome=outcome))
    store.record(_mk_record("anom-replayed", 2.0, replayed=True))
    store.record(_mk_record("anom-preempted", 2.0, preempts=1))
    for i in range(20):
        store.record(_mk_record(f"fast-{i}", 10.0 + i))
    for rid in ("slow-1", "slow-2", "anom-replayed", "anom-preempted"):
        assert store.trace(rid) is not None, rid
    for outcome in reqtrace.ANOMALOUS_OUTCOMES:
        assert store.trace(f"anom-{outcome}") is not None, outcome
    assert all(store.trace(f"fast-{i}") is None for i in range(20))
    st = store.stats()
    assert st["dropped"] == 20
    assert st["completed"] == 2 + len(reqtrace.ANOMALOUS_OUTCOMES) + 22
    assert st["replayed_requests"] == 1 and st["preempted_requests"] == 1
    assert [r["request_id"] for r in st["slowest"][:2]] \
        == ["slow-1", "slow-2"]


def test_retention_cap_evicts_fifo_but_protects_slowest():
    store = reqtrace.RequestTraceStore(sample=0.0, slowest=2, kept=4)
    store.record(_mk_record("champ-1", 5000.0))
    store.record(_mk_record("champ-2", 4000.0))
    for i in range(10):
        store.record(_mk_record(f"shed-{i}", 1.0, outcome="shed"))
    assert store.trace("champ-1") is not None
    assert store.trace("champ-2") is not None
    assert store.stats()["kept"] <= 4


def test_p99_attribution_names_the_tail_owner():
    rows = [_mk_record(f"fast-{i}", 100.0, phase_ms={
        "prefill": 40.0, "decode_steady": 55.0}) for i in range(50)]
    rows.append(_mk_record("slow", 900.0, phase_ms={
        "prefill": 45.0, "kv_transfer": 790.0, "decode_steady": 60.0}))
    rep = reqtrace.p99_attribution(rows)
    assert rep["n"] == 51 and rep["tail_owner"] == "kv_transfer"
    assert rep["tail_share"] >= 0.9
    assert rep["phases"]["kv_transfer"]["delta_ms"] > 700.0
    assert reqtrace.p99_attribution([])["tail_owner"] is None


# -------------------------------------------------- router serving path

def _tiers(tp, **decode_kw):
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    decode_kw.setdefault("max_batch", 2)
    return pf, DecodeServer(tp, TCFG, device="cpu", **decode_kw)


def test_router_owned_trace_covers_the_serving_path(model):
    jp, tp = model
    pf, dec = _tiers(tp)
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=2,
                          affinity_tokens=BS)
    try:
        toks = router.generate([1, 2, 3, 4, 5], 6)
    finally:
        dec.stop()
    jpf = jdisagg.PrefillServer(jp, JCFG, kv_block_size=BS,
                                kv_pool_blocks=32)
    jdec = jdisagg.DecodeServer(jp, JCFG, max_batch=2)
    jrouter = jdisagg.DisaggRouter(decode=[jdec], prefill=[jpf],
                                   max_queue_depth=2, affinity_tokens=BS)
    try:
        assert jrouter.generate([1, 2, 3, 4, 5], 6) == toks
    finally:
        jdec.stop()
    store = reqtrace.store()
    rows = store.summaries_since(0)
    assert len(rows) == 1 and rows[0]["outcome"] == "ok"
    for ph in ("queue_reserve", "prefill", "kv_transfer",
               "decode_first_token"):
        assert ph in rows[0]["phase_ms"], rows[0]["phase_ms"]
    kept = store.slowest(1)[0]
    seq_ms = sum(p["dur_ms"] for p in kept["phases"]
                 if not p.get("concurrent"))
    assert seq_ms <= kept["total_ms"] + 5.0
    assert seq_ms >= 0.35 * kept["total_ms"]
    # the same phases, in the same order, as the JAX router's
    jkept = jreq.store().slowest(1)[0]
    assert [p["phase"] for p in kept["phases"]] \
        == [p["phase"] for p in jkept["phases"]]
    kv = next(p for p in kept["phases"] if p["phase"] == "kv_transfer")
    assert kv["kv_bytes"] > 0 and "kv_fetch_ms" in kv


def test_router_deadline_shed_is_kept_with_cause(model):
    _, tp = model
    pf, dec = _tiers(tp)
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=2,
                          affinity_tokens=BS)
    try:
        with pytest.raises(RequestShedError):
            router.generate([1, 2, 3, 4], 6, deadline_s=0.0)
    finally:
        dec.stop()
    store = reqtrace.store()
    rows = store.summaries_since(0)
    assert len(rows) == 1 and rows[0]["outcome"] == "deadline"
    kept = store.trace(rows[0]["request_id"])
    assert kept is not None and kept["cause"] == "deadline"


def test_failover_replay_is_a_child_span_under_one_id(model):
    _, tp = model
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    d1 = DecodeServer(tp, TCFG, max_batch=4, device="cpu")
    d2 = DecodeServer(tp, TCFG, max_batch=4, device="cpu")
    # the free-slot tie-break favours the last replica: the flaky one
    router = DisaggRouter(decode=[FlakyDecode(d2),
                                  FlakyDecode(d1, die_after=3)],
                          prefill=[pf], max_queue_depth=4,
                          affinity_tokens=BS)
    try:
        assert len(router.generate([1, 2, 3, 4, 5, 6, 7, 8], 8)) == 8
    finally:
        d1.stop()
        d2.stop()
    store = reqtrace.store()
    rows = store.summaries_since(0)
    assert len(rows) == 1
    kept = store.trace(rows[0]["request_id"])
    assert kept is not None and kept["outcome"] == "ok"
    assert kept["replayed"] is True and kept["attempts"] >= 2
    assert {1, 2} <= {p["attempt"] for p in kept["phases"]}
    assert "prefill" in [p["phase"] for p in kept["phases"]
                         if p["attempt"] == 2]
    assert store.stats()["replayed_requests"] == 1


def test_disabled_store_turns_every_hook_off(model):
    """configure(enabled=False) takes the place of RAY_TPU_REQTRACE=0:
    no trace is minted, the router serves as before, nothing lands."""
    _, tp = model
    store = reqtrace.configure(enabled=False)
    assert reqtrace.start_trace() is None and not reqtrace.enabled()
    pf, dec = _tiers(tp)
    router = DisaggRouter(decode=[dec], prefill=[pf], affinity_tokens=BS)
    try:
        assert len(router.generate([1, 2, 3, 4, 5], 4)) == 4
    finally:
        dec.stop()
    assert store.stats()["completed"] == 0 and reqtrace.store() is store


# ---------------------------------------------------------- parity

def test_store_defaults_are_the_knobs_defaults():
    s = reqtrace.RequestTraceStore()
    k = jreq.RequestTraceStore._knobs()
    assert (s.slowest_n, s.sample, s.kept_cap, s.window) \
        == (k["slowest"], k["sample"], k["kept"], k["window"])
    assert s.enabled is jreq.enabled() is True
    assert reqtrace.PHASES == jreq.PHASES
    assert reqtrace.ANOMALOUS_OUTCOMES == jreq.ANOMALOUS_OUTCOMES
    assert reqtrace.CONCURRENT_PHASES == jreq.CONCURRENT_PHASES


def _summaries(seed):
    rng = np.random.default_rng(seed)
    names = list(reqtrace.PHASES) + ["kvplane_tier2_fetch"]
    out = []
    for i in range(int(rng.integers(0, 300))):
        phs = rng.choice(names, size=int(rng.integers(0, 4)), replace=False)
        out.append({"request_id": f"r{i}",
                    "total_ms": float(np.round(rng.lognormal(4, 1), 1)),
                    "phase_ms": {str(p): float(np.round(
                        rng.uniform(0, 200), 3)) for p in phs}})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_p99_attribution_matches_jax(seed):
    rows = _summaries(seed)
    assert reqtrace.p99_attribution(rows) == jreq.p99_attribution(rows)


def _records(seed, n=60):
    rng = np.random.default_rng(seed)
    outcomes = ["ok"] * 8 + sorted(reqtrace.ANOMALOUS_OUTCOMES)
    out = []
    for i in range(n):
        out.append(_mk_record(
            f"r{i}", float(np.round(rng.lognormal(4, 1), 2)),
            outcome=str(rng.choice(outcomes)),
            replayed=bool(rng.random() < 0.05),
            preempts=int(rng.random() < 0.05),
            phase_ms={"prefill": float(np.round(rng.uniform(1, 50), 2)),
                      "decode_steady": float(np.round(
                          rng.uniform(1, 90), 2))}))
    return out


@pytest.mark.parametrize("sample", [0.0, 1.0])
def test_retention_matches_jax(monkeypatch, sample):
    from ray_tpu.util import envknobs

    for knob, value in (("SAMPLE", sample), ("SLOWEST", 4), ("KEPT", 16),
                        ("WINDOW", 32)):
        monkeypatch.setenv(f"RAY_TPU_REQTRACE_{knob}", str(value))
    envknobs.clear()
    mine = reqtrace.RequestTraceStore(sample=sample, slowest=4, kept=16,
                                      window=32)
    theirs = jreq.RequestTraceStore()
    for rec in _records(seed=int(sample)):
        mine.record(dict(rec))
        theirs.record(dict(rec))
    assert mine.kept_ids() == list(theirs._kept)
    got, want = mine.stats(), theirs.stats()
    for s in (got, want):
        s.pop("component_id")
    assert got == want


def test_sampling_draw_takes_the_rng():
    """The sampled-in set is a function of the store's random.Random."""
    def kept(seed):
        s = reqtrace.RequestTraceStore(sample=0.5, slowest=1,
                                       rng=random.Random(seed))
        for rec in _records(seed=7):
            s.record(rec)
        return s.kept_ids()

    assert kept(3) == kept(3)
    assert kept(3) != kept(4)


def _strip_ts(obj):
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def _kv_snapshot(engine, spec_k):
    return {"engine_id": engine, "lookups": 5, "hits": 3, "partial_hits": 1,
            "misses": 1, "reused_tokens": 40, "prefilled_tokens": 12,
            "spliced_tokens": 0, "inserted_blocks": 6, "evictions": 2,
            "cow_copies": 1, "invalidations": 0, "admitted": 5,
            "prefill_admitted": 5, "adopted": 0, "prefill_calls": 5,
            "speculate_k": spec_k, "spec_proposed": 8 * spec_k,
            "spec_accepted": 5 * spec_k, "spec_verify_ticks": 4,
            "spec_emitted_tokens": 9, "acceptance_rate": 0.625,
            "tokens_per_verify": 2.25, "kv_int8": False}


def _events(kinds, n, **extra):
    return [dict(extra, kind=kinds[i % len(kinds)], ts=100.0 + i, seq=i)
            for i in range(n)]


SURFACES = {
    "kvcache": (
        lambda h: [h.report_kvcache_stats(f"w{i}", f"cb-{i}",
                                          _kv_snapshot(f"cb-{i}", i % 2 * 4))
                   for i in range(3)]
        + [h.report_kvcache_event(e) for e in _events(
            ["prefix_hit", "evict", "spec_accept"], 10_050, engine="cb-0")],
        lambda h: [h.get_kvcache_stats(), h.get_kvcache_events(),
                   h.get_kvcache_events(7)]),
    "speculation": (
        lambda h: [h.report_kvcache_stats("w", f"cb-{i}",
                                          _kv_snapshot(f"cb-{i}", i * 2))
                   for i in range(3)],
        lambda h: [h.get_speculation_stats()]),
    "lora": (
        lambda h: [h.report_lora_stats("w", f"pool-{i}", {
            "role": "pool", "slots": 2, "resident": 2, "pinned": i,
            "acquires": 7 + i, "hits": 4, "misses": 3 + i, "evictions": 1,
            "swaps": i, "page_in_bytes": 1000 * i,
            "tenants": {"t0": {"hits": 2, "misses": 1, "evictions": 0,
                               "swaps": i},
                        f"t{i + 1}": {"hits": 2, "misses": 2,
                                      "evictions": 1, "swaps": 0}}})
            for i in range(3)]
        + [h.report_lora_stats("w", "router-0", {
            "role": "router", "tenants": {"t0": {
                "dispatched": 4, "completed": 3, "shed": 1,
                "slo_misses": 0}}})]
        + [h.report_lora_event(e) for e in _events(
            ["page_in", "evict", "swap"], 10_020, tenant="t0")],
        lambda h: [h.get_lora_status(), h.get_lora_events(),
                   h.get_lora_events(5)]),
    "requesttrace": (
        lambda h: [h.report_requesttrace_stats("w", f"store-{i}", dict(
            reqtrace.RequestTraceStore(sample=1.0).stats(),
            completed=10 + i, kept=3, dropped=7 + i,
            outcomes={"ok": 9, "deadline": 1 + i},
            slowest=[{"request_id": f"s{i}", "total_ms": 100.0 * i}],
            recent=[{"request_id": f"x{i}-{j}", "total_ms": 10.0 * j,
                     "outcome": "ok", "phase_ms": {"prefill": 1.0 * j}}
                    for j in range(20)]))
            for i in range(70)]
        + [h.report_requesttrace_event(dict(
            _mk_record(f"q{i}", 10.0 * i), ts=200.0 + i))
           for i in range(10_010)]
        + [h.report_requesttrace_event({
            "kind": "phase", "request_id": "q10005", "phase": "kv_x",
            "dur_ms": 1.5, "attempt": 2, "ts": 9.0})],
        lambda h: [h.get_requesttrace_status(),
                   h.get_requesttrace_events(),
                   h.get_request_trace("q10005"),
                   h.get_request_trace("q1")]),
}


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_conductor_surfaces_match_jax(tmp_path, surface):
    """The same reports and events to both packages' conductor handlers
    give the same reads (the snapshots' receive times aside) and the
    same ring bounds."""
    report, read = SURFACES[surface]
    th = THandler({"CPU": 2.0}, str(tmp_path / "t"))
    jh = JHandler({"CPU": 2.0}, str(tmp_path / "j"))
    for h in (th, jh):
        report(h)
    assert _strip_ts(read(th)) == _strip_ts(read(jh))
    for bound in ("_KVCACHE_EVENTS_KEPT", "_LORA_EVENTS_KEPT",
                  "_LORA_STATS_KEPT", "_REQTRACE_EVENTS_KEPT",
                  "_REQTRACE_STATS_KEPT", "_KVCACHE_TOTAL_KEYS"):
        assert getattr(th, bound) == getattr(jh, bound), bound


def _lane_events():
    kv = _events(["prefix_hit", "evict", "invalidate", "spec_accept",
                  "spec_reject"], 40, engine="cb-1", outcome="hit",
                 reused_tokens=8, proposed=4, accepted=2)
    kv.append({"kind": "evict"})  # no ts: left out
    lora = _events(["page_in", "evict", "swap"], 12, tenant="t1",
                   version=3, bytes=4096)
    req = []
    for i in range(6):
        tr = reqtrace.RequestTrace(f"lane-{i}")
        with tr.phase("prefill"):
            pass
        if i % 2:
            tr.begin_attempt()
            with tr.phase("prefill"):
                pass
        req.append(tr.finish("ok"))
    req.append({"kind": "phase", "request_id": "lane-1", "phase": "x",
                "dur_ms": 1.0})  # remote phase: no span of its own
    return {"kvcache": kv, "lora": lora, "requests": req}


@pytest.mark.parametrize("lane", ["kvcache", "speculation", "lora",
                                  "requests"])
def test_timeline_lane_matches_jax(lane):
    events = _lane_events()
    fn = f"{lane}_trace_events"
    src = events["kvcache" if lane == "speculation" else lane]
    got = getattr(ttimeline, fn)(src)
    assert got == getattr(jtimeline, fn)(src)
    assert got and all(e["pid"] == lane for e in got)


def test_merged_trace_with_the_new_lanes_matches_jax():
    events = _lane_events()
    kw = dict(kvcache_events=events["kvcache"], lora_events=events["lora"],
              requesttrace_events=events["requests"])
    got = ttimeline.merged_chrome_trace([], [], [], **kw)
    want = jtimeline.merged_chrome_trace([], [], [], **kw)
    assert got == want
    assert {e["pid"] for e in got} == {"kvcache", "speculation", "lora",
                                       "requests"}


# ---------------------------------------------------- gateway headers


@pytest.fixture(scope="module")
def gw_stack(model):
    _, tp = model
    engine = ContinuousBatchingEngine(tp, TCFG, max_batch=2)
    router = DisaggRouter(colocated=engine, max_queue_depth=8)
    gw = GatewayServer(router, model="tiny", vocab_size=TCFG.vocab_size,
                       qos=QosGate(router=router), max_tokens_cap=64)
    host, port = gw.ready()
    yield {"host": host, "port": port, "engine": engine, "gw": gw}
    gw.stop()
    engine.stop()


def _post(host, port, path, body=None, headers=None, raw=None,
          timeout=60.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    payload = raw if raw is not None else json.dumps(body)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    conn.request("POST", path, payload, hdrs)
    return conn, conn.getresponse()


def _kept(rid):
    store = reqtrace.store()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        kept = store.trace(rid)
        if kept is not None:
            return kept
        time.sleep(0.05)
    return store.trace(rid)


def test_gateway_honors_traceparent_and_stamps_request_id(gw_stack):
    incoming_trace = "ab" * 16
    tp = f"00-{incoming_trace}-{'12' * 8}-01"
    conn, resp = _post(gw_stack["host"], gw_stack["port"],
                       "/v1/completions",
                       body={"model": "tiny", "prompt": [1, 2, 3],
                             "max_tokens": 4},
                       headers={"traceparent": tp})
    assert resp.status == 200
    rid = resp.getheader("X-Request-Id")
    assert rid and rid.startswith("cmpl-")
    assert json.loads(resp.read())["id"] == rid
    conn.close()
    # the gateway-minted trace took the INCOMING W3C trace id
    kept = reqtrace.store().trace(rid)
    assert kept is not None
    assert kept["trace_id"] == incoming_trace
    assert kept["source"] == "gateway"
    assert "qos_admission" in kept["phase_ms"]


def test_request_id_header_on_errors_and_streams(gw_stack):
    host, port = gw_stack["host"], gw_stack["port"]
    conn, resp = _post(host, port, "/v1/completions", raw=b"{not json")
    assert resp.status == 400
    assert resp.getheader("X-Request-Id")
    conn.close()
    conn, resp = _post(host, port, "/v1/completions",
                       body={"model": "nope", "prompt": [1]})
    assert resp.status == 404
    assert resp.getheader("X-Request-Id")
    conn.close()
    conn, resp = _post(host, port, "/v1/completions",
                       body={"model": "tiny", "prompt": [4, 5],
                             "max_tokens": 4, "stream": True})
    assert resp.status == 200
    rid = resp.getheader("X-Request-Id")
    assert rid and rid.startswith("cmpl-")
    while resp.readline():  # drain, so the slot frees cleanly
        pass
    conn.close()
    # routes other than the completions get the fallback id
    c2 = http.client.HTTPConnection(host, port, timeout=30.0)
    c2.request("GET", "/v1/models")
    r2 = c2.getresponse()
    assert r2.getheader("X-Request-Id", "").startswith("req-")
    r2.read()
    c2.close()


def test_gateway_stream_records_sse_flush_and_tokens(gw_stack):
    conn, resp = _post(gw_stack["host"], gw_stack["port"],
                       "/v1/completions",
                       body={"model": "tiny", "prompt": [6, 7, 8],
                             "max_tokens": 5, "stream": True})
    assert resp.status == 200
    rid = resp.getheader("X-Request-Id")
    while resp.readline():
        pass
    conn.close()
    kept = _kept(rid)
    assert kept is not None, rid
    assert kept["outcome"] == "ok"
    assert kept.get("streamed") is True
    flush = [p for p in kept["phases"] if p["phase"] == "sse_flush"]
    assert flush and flush[0]["concurrent"] is True
    assert flush[0]["writes"] >= 1


def test_preempted_stream_resumes_as_child_span_one_id(model):
    """A batch SSE stream preempted by an interactive arrival resumes and
    completes under ONE request id with the replay attempt-tagged."""
    _, tp = model
    cfg = dataclasses.replace(TCFG, max_seq_len=1024)
    engine = ContinuousBatchingEngine(tp, cfg, max_batch=1)
    router = DisaggRouter(colocated=engine, max_queue_depth=0)
    gw = GatewayServer(router, model="tiny", vocab_size=cfg.vocab_size,
                       qos=QosGate(router=router), max_tokens_cap=800)
    host, port = gw.ready()
    out = {}
    first = threading.Event()
    try:
        def batch_client():
            conn, resp = _post(host, port, "/v1/completions",
                               body={"model": "tiny",
                                     "prompt": [7, 8, 9],
                                     "max_tokens": 600, "stream": True,
                                     "priority": "batch"},
                               timeout=180.0)
            out["rid"] = resp.getheader("X-Request-Id")
            out["status"] = resp.status
            while True:
                line = resp.readline()
                if not line:
                    break
                if line.startswith(b"data: "):
                    first.set()
            conn.close()

        th = threading.Thread(target=batch_client, daemon=True)
        th.start()
        assert first.wait(60.0)  # the batch stream is producing
        conn, resp = _post(host, port, "/v1/completions",
                           body={"model": "tiny", "prompt": [4, 5],
                                 "max_tokens": 16,
                                 "priority": "interactive"},
                           timeout=120.0)
        assert resp.status == 200
        resp.read()
        conn.close()
        th.join(timeout=120)
        assert not th.is_alive()
        assert out["status"] == 200
    finally:
        gw.stop()
        engine.stop()
    kept = _kept(out["rid"])
    assert kept is not None, out
    assert kept["outcome"] == "ok"
    assert kept["preempts"] >= 1  # preempted: anomalous, kept
    assert kept["attempts"] >= 2
    # the decode after the preemption is a child span under the SAME id
    replay = [p for p in kept["phases"] if p["attempt"] >= 2]
    assert any(p["phase"].startswith("decode") for p in replay), kept
