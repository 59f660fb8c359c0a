"""The serving plane's telemetry checks that need a cluster, run by
`isolated.run_checks` in a driver process of their own
(tests/test_torch_requesttrace.py, test_torch_kvcache.py,
test_torch_speculate.py, test_torch_lora.py and test_torch_gateway.py
make each one a test case).

The twins of the JAX package's cluster cases carry their names; each
holds one workload's numbers equal across the object's own `stats()`,
the state view, the Prometheus text, the merged timeline, the CLI's
`--json` view and the dashboard's route. The `port_*` ones check what
the JAX tests leave to other layers: every family of the serving plane
reaching `prometheus_metrics()`, and a decode ACTOR's counters and
remote phase crossing its process. Every check uses Llama tiny in fp32
on the CPU from a torch seed (`serve_checks.tiny_llama`).

The Prometheus helpers (`prom_samples`, `prom_total`,
`prometheus_when`) serve the other checks' Prometheus legs too.

This module imports no torch at the top: the fork template must not.
"""
from __future__ import annotations

import json
import re
import time
from typing import Any, Callable, Dict, List, Tuple

import ray_tpu_torch as rt

from .cluster_checks import _conductor, _wait_until
from .dashboard_checks import cli_json, cli_text, dashboard_json
from .runtime_checks import _worker
from .serve_checks import BS, _engine, tiny_llama

LORA_SCALE = 6.0  # Llama tiny's tenants differ from base at this scale
PROMPT = list(range(1, 9))

_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


# ---------------------------------------------------------- Prometheus

def prom_samples(text: str, name: str) -> List[Tuple[Dict[str, str], float]]:
    """(labels, value) of every sample of `name` in Prometheus text."""
    out = []
    head = name + "{"
    for line in text.splitlines():
        if line.startswith(head):
            labels, value = line[len(head):].rsplit("} ", 1)
            out.append((dict(_LABEL.findall(labels)), float(value)))
    return out


def prom_total(text: str, family: str, /, **match: Any) -> float:
    """The sum of `family`'s samples whose labels hold `match`."""
    return sum(v for labels, v in prom_samples(text, family)
               if all(labels.get(k) == str(x) for k, x in match.items()))


def prometheus_when(pred: Callable[[str], bool], bound_s: float = 15.0,
                    what: str = "the Prometheus text") -> str:
    """Push this process's registry, then read `prometheus_metrics()`
    until `pred(text)` holds (the push is a notify, and other processes
    push on their own interval)."""
    from ..util import metrics, state

    metrics.flush()
    deadline = time.monotonic() + bound_s
    while True:
        text = state.prometheus_metrics()
        if pred(text):
            return text
        if time.monotonic() >= deadline:
            raise AssertionError(f"{what} never showed:\n{text[-4000:]}")
        time.sleep(0.1)


def _driver_label() -> str:
    return _worker().worker_id[:12]


# ------------------------------------------------------------ families

def _families() -> Dict[str, Dict[str, Any]]:
    from ..models.engine import spec_metrics
    from ..models.kvcache import kvcache_metrics
    from ..mpmd.metrics import pipeline_metrics
    from ..observability.requests import reqtrace_metrics
    from ..online.metrics import online_metrics
    from ..serve.autoscale import autoscale_metrics
    from ..serve.disagg import disagg_metrics, servefault_metrics
    from ..serve.handle import shed_counter
    from ..serve.kvplane import kvplane_metrics
    from ..serve.lora import lora_metrics
    from ..serve.qos import gateway_metrics
    from ..weights.metrics import weight_metrics

    return {"shed": {"shed": shed_counter()}, "disagg": disagg_metrics(),
            "servefault": servefault_metrics(),
            "kvplane": kvplane_metrics(),
            "autoscale": autoscale_metrics(), "online": online_metrics(),
            "pipeline": pipeline_metrics(), "weights": weight_metrics(),
            "kvcache": kvcache_metrics(), "spec": spec_metrics(),
            "lora": lora_metrics(), "reqtrace": reqtrace_metrics(),
            "gateway": gateway_metrics()}


def port_every_family_reaches_prometheus():
    """Every family of the serving plane (shed, disagg, servefault,
    kvplane, autoscale, online, pipeline, weights, kvcache, spec, lora,
    reqtrace, gateway) takes one probe sample here and shows in the driver's
    `prometheus_metrics()` with it. Returns {group: [family names]}."""
    from ..util.metrics import Gauge, Histogram

    fams = _families()
    for group in fams.values():
        for m in group.values():
            tags = {k: "probe" for k in m._tag_keys}
            if isinstance(m, Histogram):
                m.observe(1.0, tags=tags)
            elif isinstance(m, Gauge):
                m.set(1.0, tags=tags)
            else:
                m.inc(1.0, tags=tags)
    names = [m.name for g in fams.values() for m in g.values()]
    me = _driver_label()

    def shown(text: str) -> bool:
        return all(f"# TYPE {n} " in text for n in names)

    text = prometheus_when(shown, what="every family")
    for group in fams.values():
        for m in group.values():
            probe = {k: "probe" for k in m._tag_keys}
            if isinstance(m, Histogram):
                got = prom_total(text, m.name + "_count", WorkerId=me,
                                 **probe)
            else:
                got = prom_total(text, m.name, WorkerId=me, **probe)
            assert got >= 1.0, (m.name, got)
    return {g: sorted(m.name for m in group.values())
            for g, group in fams.items()}


# --------------------------------------------- tests/test_kvcache.py

def kvcache_all_surfaces_report_consistent_numbers():
    """kv_cache_stats(), the conductor's events, Prometheus and the
    timeline's kvcache lane report the same hit / miss / eviction numbers
    as the engine's own kv_stats()."""
    from ..observability import timeline
    from ..util import state

    w = _worker()
    cfg, params = tiny_llama()
    eng = _engine(params, cfg)
    try:
        shared = [21, 22, 23, 24, 25, 26, 27, 28]
        for i in range(3):
            eng.generate(shared + [90 + i], 3)
        eng.publish_kv_telemetry(force=True)
        local = eng.kv_stats()
    finally:
        eng.stop()
    key = f"{w.worker_id[:12]}:{eng.engine_id}"

    def landed():
        mine = state.kv_cache_stats()["engines"].get(key)
        return mine is not None and mine.get("lookups") == local["lookups"]

    _wait_until(landed, 10.0, "kv_cache_stats never caught up")
    st = state.kv_cache_stats()
    mine = st["engines"][key]
    for k in ("lookups", "hits", "partial_hits", "misses", "reused_tokens",
              "prefilled_tokens", "evictions"):
        assert mine[k] == local[k], k
    assert st["totals"]["hits"] == local["hits"]
    assert st["totals"]["reused_tokens"] == local["reused_tokens"]
    assert state.kv_cache_stats(engine=eng.engine_id)["engines"] \
        == {key: mine}
    hits = local["hits"] + local["partial_hits"]
    events = [e for e in _conductor().call("get_kvcache_events",
                                           timeout=10.0)
              if e.get("kind") == "prefix_hit"
              and e.get("engine") == eng.engine_id]
    assert len(events) == hits, events
    prom = prometheus_when(
        lambda t: prom_total(t, "ray_tpu_kvcache_lookups_total")
        >= local["lookups"], what="the kvcache lookups")
    assert "ray_tpu_kvcache_pool_utilization" in prom
    assert prom_total(prom, "ray_tpu_kvcache_reused_tokens_total") \
        >= local["reused_tokens"]
    trace = timeline.merged_timeline()
    markers = [e for e in trace if e.get("cat") == "kvcache"
               and e.get("args", {}).get("engine") == eng.engine_id
               and e.get("tid") == "prefix_hit"]
    assert len(markers) == hits
    assert all(m["ph"] == "i" and m["pid"] == "kvcache" for m in markers)
    # the CLI and the dashboard: the same conductor snapshot
    cli_out = cli_json("kvcache")
    assert cli_out["totals"]["hits"] == local["hits"]
    assert cli_out["totals"]["misses"] == local["misses"]
    dash = dashboard_json("/api/kvcache")
    assert dash["totals"]["hits"] == local["hits"]
    assert dash["totals"]["reused_tokens"] == local["reused_tokens"]
    assert len([e for e in dash["events"] if e.get("kind") == "prefix_hit"
                and e.get("engine") == eng.engine_id]) == hits
    return {k: local[k] for k in ("lookups", "hits", "partial_hits",
                                  "misses")}


# ------------------------------------------- tests/test_speculate.py

def speculate_all_surfaces_report_consistent_numbers():
    """speculation_stats(), the conductor's spec events, Prometheus and
    the timeline's speculation lane report the same proposal and
    acceptance numbers as the engine's own speculation_stats()."""
    import numpy as np

    from ..observability import timeline
    from ..util import state

    w = _worker()
    cfg, params = tiny_llama()
    eng = _engine(params, cfg, speculate_k=4)
    try:
        rng = np.random.default_rng(31)
        p = rng.integers(1, cfg.vocab_size, 12).tolist()
        for _ in range(3):  # repeats: drafts from the output memory
            eng.generate(p, 14)
        eng.publish_kv_telemetry(force=True)
        local = eng.speculation_stats()
    finally:
        eng.stop()
    assert local["spec_proposed"] > 0 and local["spec_accepted"] > 0
    key = f"{w.worker_id[:12]}:{eng.engine_id}"

    def landed():
        mine = state.speculation_stats()["engines"].get(key)
        return mine is not None \
            and mine["spec_proposed"] == local["spec_proposed"]

    _wait_until(landed, 10.0, "speculation_stats never caught up")
    st = state.speculation_stats()
    mine = st["engines"][key]
    for k in ("spec_proposed", "spec_accepted", "spec_verify_ticks",
              "spec_emitted_tokens"):
        assert mine[k] == local[k], k
    assert st["totals"]["spec_accepted"] == local["spec_accepted"]
    assert mine["speculate_k"] == 4
    one = state.speculation_stats(engine=eng.engine_id)
    assert one["totals"]["spec_proposed"] == local["spec_proposed"]
    events = [e for e in _conductor().call("get_kvcache_events",
                                           timeout=10.0)
              if e.get("engine") == eng.engine_id
              and str(e.get("kind", "")).startswith("spec_")]
    assert sum(e["accepted"] for e in events) == local["spec_accepted"]
    prom = prometheus_when(
        lambda t: prom_total(t, "ray_tpu_spec_accepted_total")
        >= local["spec_accepted"], what="the spec counters")
    assert "ray_tpu_spec_proposed_total" in prom
    assert prom_total(prom, "ray_tpu_spec_acceptance_rate",
                      engine=eng.engine_id) > 0
    trace = timeline.merged_timeline()
    markers = [e for e in trace if e.get("cat") == "speculation"
               and e.get("args", {}).get("engine") == eng.engine_id]
    assert len(markers) == len(events)
    assert all(m["ph"] == "i" and m["pid"] == "speculation"
               and m["tid"].startswith("spec_") for m in markers)
    assert not any(e.get("cat") == "kvcache"
                   and str(e.get("tid", "")).startswith("spec_")
                   for e in trace)
    # the CLI and the dashboard: the same conductor snapshot
    assert cli_json("speculate")["totals"]["spec_proposed"] \
        == local["spec_proposed"]
    dash = dashboard_json("/api/speculation")
    assert dash["totals"]["spec_accepted"] == local["spec_accepted"]
    spec_events = [e for e in dash["events"]
                   if e.get("engine") == eng.engine_id]
    assert spec_events and sum(e["accepted"] for e in spec_events) \
        == local["spec_accepted"]
    return {k: local[k] for k in ("spec_proposed", "spec_accepted")}


# ------------------------------------------------ tests/test_lora.py

def lora_surfaces_one_set_of_numbers():
    """A pool of 2 rows serving three tenants through a colocated
    router: lora_status() carries the pool's own stats() and the router's
    tenant counters, Prometheus the lora families, the timeline's lora
    lane the page_in and evict markers."""
    from ..models.engine import ContinuousBatchingEngine
    from ..serve.disagg import DisaggRouter
    from ..serve.lora import (AdapterPool, LocalAdapterSource,
                              make_lora_adapter)
    from ..util import state

    cfg, params = tiny_llama()
    adapters = {f"t{i}": make_lora_adapter(cfg, rank=3, seed=10 + i,
                                           scale=LORA_SCALE)
                for i in range(3)}
    pool = AdapterPool(cfg, slots=2, source=LocalAdapterSource(adapters),
                       device="cpu")
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2,
                                   lora_pool=pool)
    router = DisaggRouter(colocated=eng)
    try:
        for t in ("t0", "t1", "t0", "t2"):
            router.generate(PROMPT, 3, tenant=t)
        pool.publish_telemetry(force=True)
        router.publish_telemetry(force=True)
        ps = pool.stats()

        def landed():
            mine = state.lora_status()["pools"].get(pool.pool_id)
            return mine is not None and mine["acquires"] == ps["acquires"] \
                and "t0" in state.lora_status()["tenants"]

        _wait_until(landed, 10.0, "lora_status never caught up")
        st = state.lora_status()
        mine = st["pools"][pool.pool_id]
        for k in ("acquires", "hits", "misses", "evictions", "swaps",
                  "resident"):
            assert mine[k] == ps[k], k
        assert ps["evictions"] >= 1
        assert st["totals"]["acquires"] == ps["acquires"]
        assert st["tenants"]["t0"]["dispatched"] == 2
        events = _conductor().call("get_lora_events", timeout=10.0)
        assert any(e["kind"] == "page_in" for e in events)
        prom = prometheus_when(
            lambda t: prom_total(t, "ray_tpu_lora_adapter_misses_total")
            >= ps["misses"], what="the lora counters")
        for name in ("ray_tpu_lora_adapter_hits_total",
                     "ray_tpu_lora_adapter_evictions_total",
                     "ray_tpu_lora_pool_utilization"):
            assert name in prom, name
        assert prom_total(prom, "ray_tpu_lora_adapter_hits_total") \
            >= ps["hits"]
        trace = state.timeline(merged=True)
        lane = [e for e in trace if e.get("pid") == "lora"]
        assert len(lane) == len(events)
        assert any(e["tid"] == "page_in" for e in lane)
        assert any(e["tid"] == "evict" for e in lane)
        # the CLI and the dashboard: the same aggregate
        assert cli_json("lora")["totals"] == st["totals"]
        dash = dashboard_json("/api/lora")
        assert dash["totals"] == st["totals"]
        assert any(e["kind"] == "page_in" for e in dash["events"])
    finally:
        eng.stop()
    return {k: ps[k] for k in ("acquires", "hits", "misses", "evictions")}


# ----------------------------------------- tests/test_requesttrace.py

def requesttrace_all_surfaces_report_one_set_of_numbers():
    """requesttrace_status() carries the store's own stats(), the kept
    traces read back by id, the reqtrace families cover the workload,
    and every kept trace is real spans in the timeline's requests
    lane."""
    from ..observability import requests as reqtrace
    from ..serve.disagg import DecodeServer, DisaggRouter, PrefillServer
    from ..serve.handle import RequestShedError
    from ..util import state

    store = reqtrace.configure()
    cfg, params = tiny_llama()
    pf = PrefillServer(params, cfg, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    dec = DecodeServer(params, cfg, max_batch=2, device="cpu")
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=2,
                          affinity_tokens=BS)
    try:
        for i in range(4):
            router.generate([50 + i, 60 + i, 70 + i], 4)
        try:
            router.generate([1, 2, 3], 4, deadline_s=0.0)
            raise AssertionError("no shed past the deadline")
        except RequestShedError as e:
            assert e.cause == "deadline"
    finally:
        dec.stop()
    local = store.stats()
    assert local["completed"] == 5
    assert local["outcomes"].get("deadline") == 1
    store.publish_telemetry(force=True)

    def landed():
        mine = state.requesttrace_status()["stores"].get(
            store.component_id)
        return mine is not None and mine.get("completed") == 5

    _wait_until(landed, 10.0, "requesttrace_status never caught up")
    st = state.requesttrace_status()
    totals = st["totals"]
    assert totals["completed"] == 5 and totals["kept"] == local["kept"]
    assert totals["outcomes"] == local["outcomes"]
    assert st["attribution"]["n"] == 5
    assert st["attribution"]["tail_owner"] in reqtrace.PHASES
    kept_id = st["slowest"][0]["request_id"]
    trc = state.request_trace(kept_id)
    assert trc is not None and trc["request_id"] == kept_id
    assert trc["phases"] and trc == dict(store.trace(kept_id),
                                         ts=trc["ts"])
    assert state.request_trace("no-such-id") is None
    prom = prometheus_when(
        lambda t: prom_total(t, "ray_tpu_reqtrace_requests_total") >= 5,
        what="the reqtrace counters")
    for name in ("ray_tpu_reqtrace_phase_ms", "ray_tpu_reqtrace_kept_total",
                 "ray_tpu_reqtrace_slowest_ms"):
        assert f"# TYPE {name} " in prom, name
    assert prom_total(prom, "ray_tpu_reqtrace_requests_total",
                      outcome="deadline") >= 1
    kept = [e for e in _conductor().call("get_requesttrace_events",
                                         timeout=10.0)
            if e.get("kind") == "trace"]
    assert len(kept) == local["kept"]
    trace = state.timeline(merged=True)
    lane = [e for e in trace if e.get("pid") == "requests"]
    req_spans = [e for e in lane if e.get("cat") == "request"]
    phase_spans = [e for e in lane if e.get("cat") == "request_phase"]
    assert len(req_spans) == len(kept)
    assert len(phase_spans) == sum(len(e["phases"]) for e in kept)
    assert any(e["args"]["request_id"] == kept_id for e in req_spans)
    assert all(e["ph"] == "X" for e in req_spans + phase_spans)
    names = {e["name"] for e in phase_spans}
    assert "prefill" in names and "kv_transfer" in names
    # the CLI and the dashboard: the same aggregate, the kept trace by id
    assert cli_json("requests")["totals"] == totals
    replay = cli_json("requests", "--trace", kept_id)
    assert replay == json.loads(json.dumps(trc))
    text = cli_text("requests", "--trace", kept_id)
    assert text.startswith(f"{kept_id}: outcome=") and "prefill" in text
    dash = dashboard_json("/api/requesttrace")
    assert dash["totals"] == totals
    assert [r["request_id"] for r in dash["slowest"]] \
        == [r["request_id"] for r in st["slowest"]]
    assert any(e.get("kind") == "trace" for e in dash["events"])
    return {"completed": totals["completed"], "kept": totals["kept"]}


def requesttrace_remote_child_phases_merge_into_the_kept_trace():
    """A phase pushed from another hop under the request's id comes
    back in request_trace() as a remote phase."""
    from ..observability import requests as reqtrace
    from ..util import state

    store = reqtrace.configure()
    tr = reqtrace.RequestTrace("r-remote-1", store=store)
    with tr.phase("prefill"):
        pass
    tr.finish("preempt", cause="preempted")  # anomalous: kept, pushed
    reqtrace.push_remote_phase("r-remote-1", "kv_transfer_remote", 12.5,
                               attempt=2, server="dec-x")

    def landed():
        trc = state.request_trace("r-remote-1")
        return trc is not None and bool(trc.get("remote_phases"))

    _wait_until(landed, 10.0, "the remote phase never merged")
    remote = state.request_trace("r-remote-1")["remote_phases"]
    assert remote[0]["phase"] == "kv_transfer_remote"
    assert remote[0]["attempt"] == 2
    assert remote[0]["server"] == "dec-x"
    assert state.request_trace("no-such-id") is None


def port_actor_decode_telemetry_crosses_its_process():
    """A decode ACTOR behind a router in this driver: the stream equals
    the colocated engine's, request_trace() holds the router's
    kv_transfer phase and the actor's pushed kv_transfer_remote phase
    under one id, and the actor's ray_tpu_disagg_* series reach this
    driver's prometheus_metrics() through its own registry push."""
    from ..observability import requests as reqtrace
    from ..serve.disagg import DecodeServer, DisaggRouter, PrefillServer
    from ..util import state

    store = reqtrace.configure()
    cfg, params = tiny_llama()
    prompt = [31, 32, 33, 34, 35, 36, 37]
    colo = _engine(params, cfg)
    try:
        want = colo.generate(prompt, 6)
    finally:
        colo.stop()
    actor = rt.remote(DecodeServer).options(max_concurrency=8).remote(
        params, cfg, max_batch=2, device="cpu")
    pf = PrefillServer(params, cfg, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    router = DisaggRouter(decode=[actor], prefill=[pf], affinity_tokens=BS)
    try:
        assert router.generate(prompt, 6) == want
        rid = store.summaries_since(0)[-1]["request_id"]
        ast = rt.get(actor.stats.remote(), timeout=60.0)
        assert ast["transfers"] == 1, ast

        def merged():
            trc = state.request_trace(rid)
            return trc is not None and bool(trc.get("remote_phases"))

        _wait_until(merged, 10.0, "the actor's remote phase never merged")
        trc = state.request_trace(rid)
        assert "kv_transfer" in {p["phase"] for p in trc["phases"]}
        remote = trc["remote_phases"]
        assert [p["phase"] for p in remote] == ["kv_transfer_remote"]
        assert remote[0]["server"] == ast["server_id"]
        assert remote[0]["kv_bytes"] > 0
        me = _driver_label()

        def from_actor(text: str) -> bool:
            return any(labels.get("WorkerId") != me and v >= 1
                       for labels, v in prom_samples(
                           text, "ray_tpu_disagg_transfers_total"))

        prom = prometheus_when(from_actor, bound_s=20.0,
                               what="the actor's disagg series")
        recv = [(labels, v) for labels, v in prom_samples(
            prom, "ray_tpu_disagg_kv_bytes_total")
            if labels.get("WorkerId") != me
            and labels.get("direction") == "recv"]
        assert recv and recv[0][1] == remote[0]["kv_bytes"], recv
    finally:
        rt.get(actor.stop.remote(), timeout=60.0)
        rt.kill(actor)
    return {"request_id": rid}


def requesttrace_chaos_chunk_delay_makes_kv_transfer_the_tail_owner():
    """delay_chunk_fetch ms=200 on one decode replica: the request it
    slows tops the slowest list with kv_transfer owning its breakdown,
    and the p99 attribution names kv_transfer. The plan is the slow
    replica's ``chaos=`` (where the JAX test sets the environment for one
    request): a second router over the same prefill replica sends that
    one request there."""
    from ..observability import requests as reqtrace
    from ..serve.disagg import DecodeServer, DisaggRouter, PrefillServer

    cfg, params = tiny_llama()
    pf = PrefillServer(params, cfg, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    dec = DecodeServer(params, cfg, max_batch=2, device="cpu")
    slow = DecodeServer(params, cfg, max_batch=2, device="cpu", chaos=[
        {"action": "delay_chunk_fetch", "ms": 200}])
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=2,
                          affinity_tokens=BS)
    slow_router = DisaggRouter(decode=[slow], prefill=[pf],
                               max_queue_depth=2, affinity_tokens=BS)
    try:
        # a warm-up first, its trace dropped, then a baseline population
        # (distinct prompts: no prefix-cache shortcut hides the
        # transfer), then the one slowed request
        router.generate([1, 2, 3, 4], 4)
        store = reqtrace.configure()
        for i in range(6):
            router.generate([10 + i, 20 + i, 30 + i, 40 + i], 4)
        slow_router.generate([91, 92, 93, 94], 4)
    finally:
        dec.stop()
        slow.stop()
    slowest = store.slowest(1)[0]
    # each leaf pull sleeps 200 ms: kv_transfer owns the slowed request
    assert slowest["phase_ms"]["kv_transfer"] >= 300.0, slowest
    assert slowest["phase_ms"]["kv_transfer"] >= \
        0.5 * slowest["total_ms"], slowest
    kv_phase = next(p for p in slowest["phases"]
                    if p["phase"] == "kv_transfer")
    assert kv_phase.get("pulls", 0) >= 2, kv_phase  # the fetcher's note
    assert kv_phase.get("pull_ms", 0.0) >= 300.0, kv_phase
    rep = store.stats()["attribution"]
    assert rep["tail_owner"] == "kv_transfer", rep
    return {"kv_transfer_ms": slowest["phase_ms"]["kv_transfer"],
            "total_ms": slowest["total_ms"]}


# --------------------------------------------- tests/test_gateway.py

def gateway_state_api_sees_gateway_telemetry():
    """One request through a gateway: state.gateway_status() carries the
    replica's own stats() (accepted, completed, by_class, by_code), the
    conductor's gateway events hold its accept and first_byte markers
    and render in the timeline's gateway lane, and the
    ray_tpu_gateway_requests_total samples sum by code to by_code."""
    import http.client
    import json

    from ..models.engine import ContinuousBatchingEngine
    from ..observability.timeline import gateway_trace_events
    from ..serve.disagg import DisaggRouter
    from ..serve.gateway import GatewayServer
    from ..serve.qos import QosGate
    from ..util import state

    cfg, params = tiny_llama()
    engine = ContinuousBatchingEngine(params, cfg, max_batch=2)
    router = DisaggRouter(colocated=engine, max_queue_depth=8)
    gw = GatewayServer(router, model="tiny", vocab_size=cfg.vocab_size,
                       qos=QosGate(router=router))
    host, port = gw.ready()
    try:
        conn = http.client.HTTPConnection(host, port, timeout=60.0)
        conn.request("POST", "/v1/completions",
                     json.dumps({"model": "tiny", "prompt": [1, 2],
                                 "max_tokens": 8}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.status
        resp.read()
        conn.close()
        gw.publish_telemetry(force=True)
        mine = gw.stats()

        def landed():
            g = state.gateway_status()["gateways"].get(gw.gateway_id)
            return g is not None and g.get("completed") == 1

        _wait_until(landed, 10.0, "gateway_status never caught up")
        st = state.gateway_status()
        totals = st["totals"]
        assert totals["accepted"] == mine["accepted"] == 1, totals
        assert totals["completed"] == mine["completed"] == 1, totals
        assert totals["by_class"] == mine["by_class"], totals
        assert totals["by_class"]["interactive"]["accepted"] == 1
        assert totals["by_code"] == mine["by_code"] == {"200": 1}, totals

        def kinds():
            return {e.get("kind") for e in _conductor().call(
                "get_gateway_events", 10_000, timeout=10.0)}

        _wait_until(lambda: {"accept", "first_byte"} <= kinds(), 10.0,
                    lambda: f"gateway events: {kinds()}")
        events = _conductor().call("get_gateway_events", 10_000,
                                   timeout=10.0)
        lane = gateway_trace_events(events)
        assert lane and all(ev["pid"] == "gateway" for ev in lane)
        merged = [e for e in state.timeline(merged=True)
                  if e.get("pid") == "gateway"]
        assert {e["tid"] for e in merged} >= {"accept", "first_byte"}

        def by_code(text: str) -> Dict[str, float]:
            out: Dict[str, float] = {}
            for labels, v in prom_samples(
                    text, "ray_tpu_gateway_requests_total"):
                out[labels["code"]] = out.get(labels["code"], 0.0) + v
            return out

        prom = prometheus_when(lambda t: by_code(t) == {"200": 1.0},
                               what="the gateway's request counter")
        assert "# TYPE ray_tpu_gateway_ttft_ms " in prom
        # the CLI and the dashboard: the same aggregate
        assert cli_json("gateway")["totals"] == totals
        text = cli_text("gateway")
        assert text.startswith("totals: gateways=1 accepted=1 completed=1")
        assert f"{gw.gateway_id}: {host}:{port}" in text, text
        dash = dashboard_json("/api/gateway")
        assert dash["totals"] == totals
        assert {"accept", "first_byte"} <= {e["kind"] for e in dash["events"]}
        return {"totals": {k: totals[k] for k in (
            "accepted", "completed", "by_code")}}
    finally:
        gw.stop()
        engine.stop()


__all__ = ["prom_samples", "prom_total", "prometheus_when"]
