"""Disaggregated serving's, the KV plane's and serving fault tolerance's
checks that need a cluster, run by `isolated.run_checks` in a driver
process of their own, as `fabric_checks.py`'s are (tests/
test_torch_disagg.py, test_torch_kvplane.py and test_torch_servefault.py
make each one a test case).

The twins of the JAX package's cluster cases (tests/test_disagg.py,
test_kvplane.py, test_autoscale.py, test_servefault.py) carry their
names; the `port_*` ones check what the
JAX tests leave to other layers: a decode ACTOR killed by a chaos plan
mid-stream failing over to a replica in the driver, and one set of
numbers across the state views, the servers' stats() and the timeline's
markers. Every check uses Llama tiny in fp32 on the CPU from a torch
seed (`tiny_llama`), so a test can run the JAX package on the same
weights; a check that returns a value has it as JSON in its outcome.

This module imports no torch at the top: the fork template must not.
"""
from __future__ import annotations

import threading
import time

import numpy as np

import ray_tpu_torch as rt

from .cluster_checks import _conductor, _wait_until

BS = 4  # KV block size: small, so hit / partial / miss all show
SYSTEM_CONFIG = {"log_to_driver": 0}


def tiny_llama(seed: int = 0):
    """(config, params): Llama tiny in fp32 on the CPU from a seed."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    return cfg, llama.llama_init(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")


def _engine(params, cfg, **kw):
    from ray_tpu_torch.models.engine import ContinuousBatchingEngine

    kw.setdefault("max_batch", 4)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_pool_blocks", 32)
    return ContinuousBatchingEngine(params, cfg, **kw)


def _kv_bytes(cfg, plen: int) -> int:
    """One prompt's KV transfer: K and V, [layers, plen, kv_heads,
    head_dim] in fp32."""
    return 2 * cfg.num_layers * plen * cfg.num_kv_heads * cfg.head_dim * 4


class FlakyDecode:
    """A DecodeServer whose next_tokens pulls one token at a time and
    raises ConnectionError (the shape of a death) once it served
    `die_after` tokens."""

    def __init__(self, inner, die_after=10 ** 9):
        self._inner = inner
        self._served = 0
        self._die = die_after
        self.dead = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def start_decode(self, *a, **k):
        if self.dead:
            raise ConnectionError("replica is dead")
        return self._inner.start_decode(*a, **k)

    def next_tokens(self, hid, max_tokens=64, wait_s=2.0):
        if self.dead:
            raise ConnectionError("replica is dead")
        out = self._inner.next_tokens(hid, 1, wait_s)
        self._served += len(out["tokens"])
        if self._served >= self._die and not out["done"]:
            self.dead = True
            raise ConnectionError("replica died mid-stream")
        return out


# -------------------------------------------------- tests/test_disagg.py

def disagg_cross_replica_transfer_bit_identical_no_full_copy():
    """A prefill ACTOR streams KV blocks to a decode ACTOR: streams equal
    the colocated engine's for hit, partial and miss outcomes; the
    fetched bytes are exactly the prompts' KV rows, all over shm; the
    decode process never prefilled; every transfer acked."""
    from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                            PrefillServer)

    cfg, params = tiny_llama()
    prefill = rt.remote(PrefillServer).options(max_concurrency=4).remote(
        params, cfg, kv_block_size=BS, kv_pool_blocks=32, device="cpu")
    decode = rt.remote(DecodeServer).options(max_concurrency=8).remote(
        params, cfg, max_batch=4, device="cpu")
    colo = _engine(params, cfg)
    router = DisaggRouter(decode=[decode], prefill=[prefill],
                          max_queue_depth=4, affinity_tokens=BS)
    base = [1, 2, 3, 4, 5, 6, 7, 8]
    prompts = [base, base, base + [9, 10, 11, 12, 13], [5, 5, 5]]
    streams = []
    try:
        for p in prompts:
            want = colo.generate(p, 6)
            got = router.generate(p, 6)
            assert got == want, (p, got, want)
            streams.append(got)
        _wait_until(lambda: rt.get(prefill.stats.remote())["acked"]
                    >= len(prompts), 10.0, "the acks never landed")
        pf_stats = rt.get(prefill.stats.remote())
        dec_stats = rt.get(decode.stats.remote())
    finally:
        colo.stop()
        rt.get(decode.stop.remote(), timeout=30.0)
        rt.kill(prefill)
        rt.kill(decode)
    pc = pf_stats["prefix_cache"]
    assert pc["hits"] >= 1 and pc["partial_hits"] >= 1 \
        and pc["misses"] >= 2, pc
    assert pf_stats["reused_tokens"] > 0
    expect = sum(_kv_bytes(cfg, len(p)) for p in prompts)
    assert pf_stats["published_bytes"] == expect
    assert dec_stats["kv_fetched_bytes"] == expect
    assert dec_stats["shm_bytes"] == expect, dec_stats
    assert dec_stats["rpc_bytes"] == 0
    assert dec_stats["transfers"] == len(prompts)
    assert dec_stats["adopted"] == len(prompts)
    assert dec_stats["prefill_programs"] == 0
    assert pf_stats["acked"] == len(prompts)
    assert pf_stats["held_transfers"] == 0
    return {"streams": streams, "prefill_stats": sorted(pf_stats),
            "decode_stats": sorted(dec_stats)}


# ------------------------------------------------- tests/test_kvplane.py

def kvplane_directory_atomic_commit_and_namespace_isolation():
    c = _conductor()
    dig = "ab" * 32
    meta = {"holder": "pf-first", "desc": {"n": 1}, "tokens": 8,
            "nbytes": 123}
    assert c.call("kvplane_publish", "", dig, meta) == \
        {"status": "committed"}
    res2 = c.call("kvplane_publish", "", dig, dict(meta, holder="pf-second"))
    assert res2["status"] == "already" and res2["holder"] == "pf-first"
    entry = c.call("kvplane_lookup", "", ["ff" * 32, dig])
    assert entry["holder"] == "pf-first" and entry["digest"] == dig
    assert entry["tokens"] == 8 and "started" not in entry
    assert c.call("kvplane_lookup", "tenantA|v1", [dig]) is None
    bad = c.call("kvplane_publish", "", "cd" * 32, {"n": 1})
    assert bad.get("error")
    assert c.call("kvplane_unpublish", "", dig) is True
    assert c.call("kvplane_lookup", "", [dig]) is None


def kvplane_directory_ttl_reap_and_gc():
    """The TTL is the lookup's argument (the JAX test sets
    RAY_TPU_KVPLANE_T3_TTL_S)."""
    c = _conductor()
    meta = {"holder": "pf-ttl", "desc": {}, "tokens": 8, "nbytes": 1}
    assert c.call("kvplane_publish", "ttl", "aa" * 32,
                  meta)["status"] == "committed"
    time.sleep(0.1)
    assert c.call("kvplane_lookup", "ttl", ["aa" * 32], 0.05) is None
    for i in range(2):
        c.call("kvplane_publish", "ttl", f"{i:02d}" * 32, meta)
    assert c.call("kvplane_reap", 0.0) >= 2
    for i in range(5):
        c.call("kvplane_publish", "gcns", f"b{i}" * 32, meta)
    assert c.call("kvplane_gc", 2, "gcns") == 3
    st = c.call("get_kvplane_status")
    assert st["directory"]["namespaces"].get("gcns") == 2
    ctr = st["directory"]["counters"]
    assert ctr["reaped"] >= 3 and ctr["gced"] >= 3
    # an entry within its TTL is found; the default TTL is 600 s
    c.call("kvplane_publish", "live", "cc" * 32, meta)
    assert c.call("kvplane_lookup", "live", ["cc" * 32])["holder"] \
        == "pf-ttl"


def kvplane_router_directory_hit_and_holder_death_fallback():
    """A live holder wins; an entry whose holder left degrades to the
    hash plus a tier-3 hint (a bogus descriptor fails harmlessly); a miss
    falls back to the hash."""
    from ray_tpu_torch.models.kvcache import prefix_digests
    from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                            PrefillServer)

    cfg, params = tiny_llama()
    pf = PrefillServer(params, cfg, kv_block_size=BS, kv_pool_blocks=32,
                       kvplane=True, device="cpu")
    dec = DecodeServer(params, cfg, max_batch=2, device="cpu")
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=4,
                          affinity_tokens=BS)
    prompt = list(range(101, 113))  # 3 full blocks: past the floor
    ghost = list(range(201, 213))
    try:
        out1 = router.generate(prompt, 4)
        out2 = router.generate(prompt, 4)
        assert out2 == out1
        digs = prefix_digests(ghost, BS, None)
        assert _conductor().call(
            "kvplane_publish", "", digs[0],
            {"holder": "pf-ghost", "desc": {"bogus": True}, "tokens": 8,
             "nbytes": 0})["status"] == "committed"
        out3 = router.generate(ghost, 4)
        assert len(out3) == 4
    finally:
        dec.stop()
    rs = router.stats()
    assert rs["directory_misses"] >= 1 and rs["directory_hits"] >= 1 \
        and rs["directory_fallbacks"] >= 1, rs
    kst = pf.kvplane_stats()
    assert kst["tier3_publishes"] >= 1 and kst["t3_held_refs"] >= 1
    rks = router.kvplane_stats()
    assert rks["enabled"] and rks["kv_block_size"] == BS
    assert rks["directory_hits"] == rs["directory_hits"]
    return {"prompt": prompt, "ghost": ghost, "streams": [out1, out3]}


def kvplane_chunk_fetcher_caller_attribution():
    from ray_tpu_torch.util import chunks

    def reads(totals):
        return totals.get("chunks_local", 0) + totals.get("chunks_fetched",
                                                          0)

    w = rt._private.worker.global_worker
    payload = {"x": np.arange(4096, dtype=np.int8)}
    refs, desc = chunks.put_tree(w, payload)
    before = reads(chunks.caller_totals("kvplane"))
    f = chunks.ChunkFetcher(w, caller="kvplane")
    got = chunks.fetch_tree(w, desc, fetcher=f)
    assert np.array_equal(got["x"], payload["x"])
    st = f.stats()
    assert st["caller"] == "kvplane" and reads(st) >= 1
    after = reads(chunks.caller_totals("kvplane"))
    assert after - before == reads(st)
    kv_before = reads(chunks.caller_totals("kv"))
    f2 = chunks.ChunkFetcher(w, caller="kv")
    chunks.fetch_tree(w, desc, fetcher=f2)
    assert reads(chunks.caller_totals("kv")) == kv_before + reads(f2.stats())
    assert reads(chunks.caller_totals("kvplane")) == after
    assert chunks.ChunkFetcher(w).stats()["caller"] == "unlabeled"
    del refs


# ------------------------------------------------ tests/test_autoscale.py

class _ForcedPolicy:
    """decide() returns fixed targets: the loop's scale-up and drain
    mechanics without shaping real load."""

    target_p99_ms = 1500.0

    def __init__(self, targets):
        self.targets = dict(targets)

    def decide(self, signals, current, now=None):
        return {tier: (self.targets.get(tier, cur),
                       "forced" if self.targets.get(tier, cur) != cur
                       else "hold")
                for tier, cur in current.items()}


def _stop_local(router) -> None:
    for tier in ("prefill", "decode"):
        for r in router.tier_replicas(tier):
            stop = getattr(r["target"], "stop", None)
            if callable(stop) and getattr(stop, "remote", None) is None:
                stop()


def autoscale_scale_down_drains_zero_dropped_inflight():
    """A forced decode scale-down while both replicas hold a slow request
    stops dispatch to the victim (the newest: an ACTOR, with real
    chunk-fabric transfers) but lets its request finish and every KV
    transfer be acked before the actor is killed: nothing dropped,
    nothing forced."""
    from ray_tpu_torch.serve.autoscale import DisaggAutoscaler, TierSpec
    from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                            PrefillServer)

    cfg, params = tiny_llama()
    pf = PrefillServer(params, cfg, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    dec_local = DecodeServer(params, cfg, max_batch=1, device="cpu")
    dec_actor = rt.remote(DecodeServer).options(max_concurrency=6).remote(
        params, cfg, max_batch=1, device="cpu")
    rt.get(dec_actor.stats.remote(), timeout=120.0)
    router = DisaggRouter(decode=[dec_local, dec_actor], prefill=[pf],
                          max_queue_depth=0, affinity_tokens=BS)
    scaler = DisaggAutoscaler(
        router,
        prefill=TierSpec(lambda: PrefillServer(params, cfg, device="cpu"),
                         min_replicas=1, max_replicas=2),
        decode=TierSpec(lambda: DecodeServer(params, cfg, max_batch=1,
                                             device="cpu"),
                        min_replicas=1, max_replicas=2),
        policy=_ForcedPolicy({"decode": 1, "prefill": 1}),
        interval_s=3600, drain_grace_s=60)
    shared = [21, 22, 23, 24, 25, 26, 27, 28]
    router.generate(shared, 2)  # lands on the actor (ties go last)
    results = []
    admitted = [threading.Event(), threading.Event()]

    def one(i):
        results.append(router.generate(
            shared + [40 + i], 6, on_first_token=admitted[i].set,
            token_sleep_s=0.25))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for ev in admitted:
            assert ev.wait(60.0)
        actions = scaler.tick()
        assert [a["kind"] for a in actions] == ["drain"], actions
        victim = actions[0]["replica"]
        reps = {r["rid"]: r for r in router.tier_replicas("decode")}
        assert reps[victim]["draining"]
        assert reps[victim]["inflight"] == 1
        assert not any(a["kind"] == "scale_down" for a in scaler.tick())
        for t in threads:
            t.join(timeout=120)
        assert sorted(len(r) for r in results) == [6, 6]
        deadline = time.monotonic() + 60.0
        final = []
        while time.monotonic() < deadline:
            final = scaler.tick()
            if any(a["kind"] == "scale_down" for a in final):
                break
            time.sleep(0.05)
        down = [a for a in final if a["kind"] == "scale_down"]
        assert down and down[0]["replica"] == victim, final
        assert down[0]["drained"] is True
        st = scaler.status()
        assert st["drains_completed"] == 1 and st["drains_forced"] == 0, st
        assert len(router.tier_replicas("decode")) == 1
        pf_stats = pf.stats()
        assert pf_stats["held_transfers"] == 0
        assert pf_stats["acked"] == pf_stats["published_transfers"] == 3, \
            pf_stats
        rs = router.stats()
        assert rs["completed"] == rs["dispatched"]
        deadline = time.monotonic() + 30.0
        dead = False
        while time.monotonic() < deadline and not dead:
            try:
                rt.get(dec_actor.stats.remote(), timeout=5.0)
                time.sleep(0.2)
            except Exception:  # noqa: BLE001 — the kill landed
                dead = True
        assert dead, "the drained actor is still alive"
    finally:
        for t in threads:
            t.join(timeout=60)
        scaler.stop()
        _stop_local(router)


def autoscale_all_surfaces_report_consistent_numbers():
    """One scale-up, drain and scale-down sequence: autoscaler_status()
    carries the loop's own status (totals included) and the timeline's
    autoscale lane one marker per decision, the drain also in the
    resilience lane as serve_drain."""
    from ray_tpu_torch.observability import timeline
    from ray_tpu_torch.serve.autoscale import DisaggAutoscaler, TierSpec
    from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                            PrefillServer)
    from ray_tpu_torch.util import state

    cfg, params = tiny_llama()
    router = DisaggRouter(
        decode=[DecodeServer(params, cfg, max_batch=1, device="cpu")],
        prefill=[PrefillServer(params, cfg, kv_block_size=BS,
                               kv_pool_blocks=32, device="cpu")],
        max_queue_depth=1, affinity_tokens=BS)
    scaler = DisaggAutoscaler(
        router,
        prefill=TierSpec(lambda: PrefillServer(params, cfg, device="cpu"),
                         min_replicas=1, max_replicas=2),
        decode=TierSpec(lambda: DecodeServer(params, cfg, max_batch=1,
                                             device="cpu"),
                        min_replicas=1, max_replicas=2),
        policy=_ForcedPolicy({"decode": 2, "prefill": 1}),
        interval_s=3600, drain_grace_s=30)
    try:
        router.generate([61, 62, 63, 64, 65], 2)
        up = scaler.tick()
        assert [a["kind"] for a in up] == ["scale_up"], up
        scaler.policy = _ForcedPolicy({"decode": 1, "prefill": 1})
        mid = scaler.tick()
        assert [a["kind"] for a in mid] == ["drain"], mid
        deadline = time.monotonic() + 30.0
        done = []
        while time.monotonic() < deadline:
            done = scaler.tick()
            if any(a["kind"] == "scale_down" for a in done):
                break
            time.sleep(0.05)
        assert any(a["kind"] == "scale_down" for a in done)
        local = scaler.status()
        assert local["scale_ups"]["decode"] == 1
        assert local["scale_downs"]["decode"] == 1
        assert local["drains_completed"] == 1
    finally:
        scaler.publish_telemetry(force=True)
        _stop_local(router)

    def landed():
        st = state.autoscaler_status()
        mine = st["autoscalers"].get(scaler.autoscaler_id)
        return mine is not None and mine.get("drains_completed") == 1

    _wait_until(landed, 10.0, "autoscaler_status never caught up")
    st = state.autoscaler_status()
    mine = st["autoscalers"][scaler.autoscaler_id]
    totals = st["totals"]
    assert totals["scale_ups"] >= 1 and totals["scale_downs"] >= 1
    assert totals["drains_completed"] == 1 and totals["autoscalers"] == 1
    assert mine["scale_ups"] == local["scale_ups"]
    assert mine["scale_downs"] == local["scale_downs"]
    assert mine["replica_seconds"]["decode"] > 0
    assert totals["active_replicas"]["decode"] == 1
    trace = timeline.merged_timeline()
    markers = [e for e in trace if e.get("cat") == "autoscale"
               and e["args"].get("autoscaler") == scaler.autoscaler_id]
    assert sorted(m["tid"] for m in markers) \
        == ["drain", "scale_down", "scale_up"], markers
    assert all(m["ph"] == "i" and m["pid"] == "autoscale" for m in markers)
    resil = [e for e in trace if e.get("cat") == "resilience"
             and e.get("tid") == "serve_drain"]
    assert len(resil) == 1
    # Prometheus: the autoscale families cover the loop's decisions
    from .telemetry_checks import prom_total, prometheus_when

    def decided(text):
        return prom_total(text, "ray_tpu_autoscale_decisions_total",
                          tier="decode", direction="down") >= 1

    prom = prometheus_when(decided, what="the autoscale decisions")
    assert prom_total(prom, "ray_tpu_autoscale_decisions_total",
                      tier="decode", direction="up") >= 1
    assert prom_total(prom, "ray_tpu_autoscale_replica_seconds_total",
                      tier="decode") > 0
    assert "# TYPE ray_tpu_autoscale_target_replicas gauge" in prom
    # the CLI and the dashboard: the same aggregate
    from .dashboard_checks import cli_json, cli_text, dashboard_json

    cli_out = cli_json("autoscale")
    assert cli_out["totals"] == totals
    assert cli_out["autoscalers"][scaler.autoscaler_id]["scale_ups"] \
        == local["scale_ups"]
    assert f"  {scaler.autoscaler_id}: router=" in cli_text("autoscale")
    dash = dashboard_json("/api/autoscale")
    assert dash["totals"] == totals
    by_kind: dict = {}
    for ev in dash["events"]:
        if ev.get("autoscaler") == scaler.autoscaler_id:
            by_kind[ev["kind"]] = by_kind.get(ev["kind"], 0) + 1
    assert by_kind == {"scale_up": 1, "drain": 1, "scale_down": 1}, by_kind
    return {"totals": totals}


# ----------------------------------------------- tests/test_servefault.py

def servefault_actor_decode_kill_mid_stream_heals_and_completes():
    """ONE decode actor killed by its chaos plan at its 4th token; the
    self-healer (watch(): the actor_state channel, no tick) replaces it
    through the tier factory while the router's failover waits for the
    survivor and replays the prompt with the dead replica's tokens: the
    stream equals an uninterrupted run's, nothing is dropped, the death
    and the replacement are counted, and a second request runs entirely
    on the replacement."""
    from ray_tpu_torch.serve.autoscale import DisaggAutoscaler, TierSpec
    from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                            PrefillServer)
    from ray_tpu_torch.util import state

    cfg, params = tiny_llama()
    p = [21, 22, 23, 24, 25, 26, 27, 28]
    colo = _engine(params, cfg)
    try:
        want = colo.generate(p, 10)
    finally:
        colo.stop()
    plan = [{"action": "kill_replica", "role": "decode", "at": "token:4",
             "replica": 0}]
    made = {"n": 0}

    def decode_factory():
        idx = made["n"]
        made["n"] += 1
        a = rt.remote(DecodeServer).options(max_concurrency=8).remote(
            params, cfg, max_batch=2, chaos=plan, chaos_replica=idx,
            device="cpu")
        rt.get(a.stats.remote(), timeout=120.0)
        return a

    def prefill_factory():
        a = rt.remote(PrefillServer).options(max_concurrency=4).remote(
            params, cfg, kv_block_size=BS, kv_pool_blocks=32, device="cpu")
        rt.get(a.stats.remote(), timeout=120.0)
        return a

    pf = prefill_factory()
    dec0 = decode_factory()
    router = DisaggRouter(decode=[dec0], prefill=[pf], max_queue_depth=4,
                          affinity_tokens=BS, failover_wait_s=90.0)
    hold = dict(min_replicas=1, max_replicas=2, up_delay_s=3600.0,
                down_delay_s=3600.0)
    scaler = DisaggAutoscaler(
        router, prefill=TierSpec(prefill_factory, **hold),
        decode=TierSpec(decode_factory, **hold),
        interval_s=3600.0, drain_grace_s=5.0)
    try:
        scaler.watch()
        got = router.generate(p, 10, timeout_s=120.0)
        assert got == want, (got, want)
        st = router.stats()
        assert st["failovers"]["decode"] >= 1, st
        assert st["failover_requests"] == 1 and st["shed"] == 0, st
        _wait_until(lambda: scaler.servefault_stats()["replacements"]
                    ["decode"] >= 1, 30.0, "the healer never replaced")
        hs = scaler.servefault_stats()
        assert hs["deaths"]["decode"] == 1, hs
        assert hs["replacements"]["decode"] == 1, hs
        assert hs["breaker_trips"] == 0, hs
        reps = router.tier_replicas("decode")
        assert len(reps) == 1 and reps[0]["target"] is not dec0
        info = _conductor().call("get_actor_info", dec0.actor_id,
                                 timeout=5.0)
        assert info["state"] == "DEAD", info
        again = router.generate(p, 10, timeout_s=120.0)
        assert again == want
        # the replay of the failed-over request waited for the
        # replacement, and the second request ran there too
        assert rt.get(reps[0]["target"].stats.remote(),
                      timeout=30.0)["transfers"] == 2
        _wait_until(lambda: rt.get(pf.stats.remote(), timeout=10.0)
                    ["held_transfers"] == 0, 15.0, "a transfer is held")
        scaler.publish_servefault(force=True)
        _wait_until(lambda: state.servefault_status()["totals"]
                    ["replacements"]["decode"] == 1, 10.0,
                    "servefault_status never counted the replacement")
        kinds = [e["kind"] for e in
                 _conductor().call("get_servefault_events")]
        assert "replica_death" in kinds and "replace" in kinds, kinds
        from .dashboard_checks import cli_json, dashboard_json

        sf = state.servefault_status()
        assert cli_json("servefault")["totals"] == sf["totals"]
        dash = dashboard_json("/api/servefault")
        assert dash["totals"] == sf["totals"]
        assert {"failover", "replace"} <= {e.get("kind")
                                           for e in dash["events"]}
        # Prometheus: the healer's replacement and the router's failover
        # (both in this driver)
        from .telemetry_checks import prom_total, prometheus_when

        prom = prometheus_when(
            lambda t: prom_total(t, "ray_tpu_servefault_replacements_total",
                                 tier="decode") >= 1,
            what="the replacement")
        assert prom_total(prom, "ray_tpu_servefault_failovers_total",
                          phase="decode") >= st["failovers"]["decode"]
    finally:
        scaler.stop()
        for t in ("prefill", "decode"):
            for r in router.tier_replicas(t):
                try:
                    rt.kill(r["target"])
                except Exception:  # noqa: BLE001 — already dead
                    pass
    return {"streams": [got, again]}


# ------------------------------------------------------------- the port

def port_servefault_actor_decode_kill_fails_over():
    """A decode ACTOR carrying a kill_replica plan (token:4) dies
    mid-stream; the router sees the death from its next pull, prefills
    the prompt plus the dead replica's tokens again (a prefix hit) and
    resumes on the driver's decode replica: the stream equals the
    colocated engine's. The death is counted by the router and in
    servefault_status(), the chaos fire and the failover land in the
    resilience events, and the actor is DEAD."""
    from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                            PrefillServer)
    from ray_tpu_torch.util import state

    cfg, params = tiny_llama()
    prompt = [21, 22, 23, 24, 25, 26, 27, 28]
    colo = _engine(params, cfg)
    try:
        want = colo.generate(prompt, 12)
    finally:
        colo.stop()
    plan = [{"action": "kill_replica", "role": "decode", "at": "token:4",
             "replica": 0}]
    actor = rt.remote(DecodeServer).options(max_concurrency=8).remote(
        params, cfg, max_batch=2, chaos=plan, device="cpu")
    rt.get(actor.describe.remote(), timeout=120.0)
    pf = PrefillServer(params, cfg, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    local = DecodeServer(params, cfg, max_batch=2, device="cpu")
    # ties of the free-slot refinement go to the last replica: the actor
    router = DisaggRouter(decode=[local, actor], prefill=[pf],
                          max_queue_depth=2, affinity_tokens=BS,
                          stream_chunk_tokens=2)
    try:
        got = router.generate(prompt, 12)
    finally:
        local.stop()
    assert got == want, (got, want)
    st = router.stats()
    assert st["failovers"] == {"prefill": 0, "decode": 1}, st
    assert st["failover_requests"] == 1 and st["shed"] == 0
    assert [r["rid"] for r in router.tier_replicas("decode")] \
        == [local.server_id]
    pst = pf.stats()
    assert pst["published_transfers"] == 2 and pst["reused_tokens"] > 0
    assert local.stats()["transfers"] == 1
    router.publish_servefault(force=True)
    _wait_until(lambda: state.servefault_status()["totals"]["failovers"]
                ["decode"] == 1, 10.0, "servefault_status never counted")
    sf = state.servefault_status()["totals"]
    assert sf["removed_dead"]["decode"] == 1, sf
    kinds = [e["kind"] for e in _conductor().call("get_servefault_events")]
    assert "chaos" in kinds and "failover" in kinds, kinds
    info = _conductor().call("get_actor_info", actor.actor_id, timeout=5.0)
    assert info["state"] == "DEAD", info
    return {"stream": got}


def port_disagg_one_set_of_numbers():
    """One workload (transfers, a spill-heavy int8 prefill tier, a shed,
    a decode failover, a deadline shed): disagg_status(),
    kvplane_status() and servefault_status() carry the servers' and the
    router's own stats(), and the timeline's disagg, kvplane and
    resilience lanes one marker per transfer, spill, shed and failover."""
    from ray_tpu_torch.observability import timeline
    from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                            PrefillServer)
    from ray_tpu_torch.serve.handle import RequestShedError
    from ray_tpu_torch.util import state

    cfg, params = tiny_llama()
    pf = PrefillServer(params, cfg, kv_block_size=BS, kv_pool_blocks=8,
                       kv_int8=True, kvplane_arena_bytes=64 << 20,
                       device="cpu")
    d1 = DecodeServer(params, cfg, max_batch=1, device="cpu")
    d2 = DecodeServer(params, cfg, max_batch=1, device="cpu")
    flaky = FlakyDecode(d2, die_after=2)
    router = DisaggRouter(decode=[d1, flaky], prefill=[pf],
                          max_queue_depth=0, affinity_tokens=BS)
    prompts = [list(range(30 * i + 301, 30 * i + 313)) for i in range(4)]
    try:
        for p in prompts + prompts:  # overflow the pool, then readopt
            router.generate(p, 4)
        # d1 alone with queue depth 0: a second request at once sheds
        admitted = threading.Event()
        hold = threading.Thread(target=lambda: router.generate(
            prompts[0], 8, on_first_token=admitted.set, token_sleep_s=0.2))
        hold.start()
        assert admitted.wait(30.0)
        try:
            router.generate(prompts[1], 2)
            raise AssertionError("no shed at capacity")
        except RequestShedError as e:
            assert e.cause == "capacity"
        hold.join(60.0)
        try:
            router.generate(prompts[1], 2, deadline_s=0.0)
            raise AssertionError("no shed past the deadline")
        except RequestShedError as e:
            assert e.cause == "deadline"
    finally:
        d1.stop()
        d2.stop()
    for comp in (pf, d1, d2, router):
        comp.publish_telemetry(force=True)
    router.publish_servefault(force=True)
    local = {"pf": pf.stats(), "d1": d1.stats(), "d2": d2.stats(),
             "router": router.stats(), "kvp": pf.kvplane_stats(),
             "rkvp": router.kvplane_stats(),
             "sf": router.servefault_stats()}
    assert local["kvp"]["spills"] > 0 and local["kvp"]["tier2_hits"] > 0
    assert local["router"]["failovers"]["decode"] == 1

    def landed():
        ds = state.disagg_status()
        ks = state.kvplane_status()
        ss = state.servefault_status()
        r = ds["routers"].get(router.router_id, {})
        return (ds["decode"].get(d1.server_id, {}).get("transfers")
                == local["d1"]["transfers"]
                and r.get("shed") == local["router"]["shed"]
                and ks["components"].get(pf.server_id, {}).get("spills")
                == local["kvp"]["spills"]
                and ss["routers"].get(router.router_id, {}).get(
                    "sheds_by_cause") == local["sf"]["sheds_by_cause"])

    _wait_until(landed, 10.0, "the snapshots never landed")
    ds, ks, ss = (state.disagg_status(), state.kvplane_status(),
                  state.servefault_status())
    for key in ("prefills", "reused_tokens", "published_transfers",
                "published_bytes"):
        assert ds["prefill"][pf.server_id][key] == local["pf"][key], key
    transfers = local["d1"]["transfers"] + local["d2"]["transfers"]
    assert ds["totals"]["transfers"] == transfers
    assert ds["totals"]["published_transfers"] \
        == local["pf"]["published_transfers"]
    assert ds["totals"]["shed"] == local["router"]["shed"] == 2
    assert ds["totals"]["dispatched"] == local["router"]["dispatched"]
    for key in ("spills", "tier2_hits", "tier2_reused_tokens", "entries"):
        assert ks["components"][pf.server_id][key] == local["kvp"][key], key
    assert ks["totals"]["spills"] == local["kvp"]["spills"]
    assert ks["totals"]["directory_misses"] \
        == local["rkvp"]["directory_misses"]
    assert ss["totals"]["failovers"] == local["sf"]["failovers"]
    assert ss["totals"]["sheds_by_cause"] == {"capacity": 1, "deadline": 1}
    trace = timeline.merged_timeline()

    def markers(lane, kind, **where):
        return [e for e in trace if e.get("pid") == lane
                and e.get("tid") == kind and e["ph"] == "i"
                and all(e["args"].get(k) == v for k, v in where.items())]

    assert len(markers("disagg", "kv_transfer")) == transfers
    assert sum(e["args"]["bytes"] for e in markers("disagg", "kv_publish")) \
        == local["pf"]["published_bytes"]
    assert len(markers("disagg", "shed", router=router.router_id)) == 2
    assert len(markers("kvplane", "spill", replica=pf.server_id)) \
        == local["kvp"]["spills"]
    assert len(markers("kvplane", "tier2_hit", replica=pf.server_id)) \
        == local["kvp"]["tier2_hits"]
    assert len(markers("resilience", "failover",
                       router=router.router_id)) == 1
    # Prometheus: every tier is in this driver, so this process's
    # families cover the workload's numbers
    from .telemetry_checks import prom_total, prometheus_when

    prom = prometheus_when(
        lambda t: prom_total(t, "ray_tpu_disagg_transfers_total")
        >= transfers, what="the disagg transfers")
    assert prom_total(prom, "ray_tpu_disagg_kv_bytes_total",
                      direction="send") >= local["pf"]["published_bytes"]
    assert f'router="{router.router_id}"' in prom  # its queue depth gauge
    for cause in ("capacity", "deadline"):
        assert prom_total(prom, "ray_tpu_servefault_sheds_total",
                          cause=cause) >= 1, cause
    assert prom_total(prom, "ray_tpu_servefault_failovers_total",
                      phase="decode") >= 1
    assert prom_total(prom, "ray_tpu_serve_shed_total", app="disagg",
                      deployment=router.router_id) == 2
    assert prom_total(prom, "ray_tpu_kvplane_spills_total") \
        >= local["kvp"]["spills"]
    assert prom_total(prom, "ray_tpu_kvplane_hits_total", tier="2") \
        >= local["kvp"]["tier2_hits"]
    assert prom_total(prom, "ray_tpu_kvplane_directory_total") \
        >= local["rkvp"]["directory_misses"]
    # the CLI and the dashboard: the same aggregates
    from .dashboard_checks import cli_json, cli_text, dashboard_json

    assert cli_json("disagg")["totals"] == ds["totals"]
    dash = dashboard_json("/api/disagg")
    assert dash["totals"] == ds["totals"]
    sent = [e for e in dash["events"] if e.get("kind") == "kv_publish"]
    assert sum(e["bytes"] for e in sent) == local["pf"]["published_bytes"]
    cli_k = cli_json("kvplane")
    assert cli_k["totals"] == ks["totals"]
    assert cli_k["directory"] == ks["directory"]
    dash = dashboard_json("/api/kvplane")
    assert dash["totals"] == ks["totals"]
    assert dash["directory"] == ks["directory"]
    assert {"spill", "tier2_hit"} <= {e.get("kind") for e in dash["events"]}
    assert cli_json("servefault")["totals"] == ss["totals"]
    dash = dashboard_json("/api/servefault")
    assert dash["totals"] == ss["totals"]
    assert "failover" in {e.get("kind") for e in dash["events"]}
    for view in ("disagg", "kvplane", "servefault"):
        assert cli_text(view).startswith("totals: "), view
    return {"transfers": transfers, "spills": local["kvp"]["spills"],
            "sheds": local["router"]["sheds_by_cause"]}


__all__ = ["BS", "SYSTEM_CONFIG", "FlakyDecode", "tiny_llama"]
