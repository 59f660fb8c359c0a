"""Disaggregated serving's, the KV plane's and serving fault tolerance's
checks that need a cluster, run by `isolated.run_checks` in a driver
process of their own, as `fabric_checks.py`'s are (tests/
test_torch_disagg.py, test_torch_kvplane.py and test_torch_servefault.py
make each one a test case).

The twins of the JAX package's cluster cases (tests/test_disagg.py,
test_kvplane.py) carry their names; the `port_*` ones check what the
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
    return {"transfers": transfers, "spills": local["kvp"]["spills"],
            "sheds": local["router"]["sheds_by_cause"]}


__all__ = ["BS", "SYSTEM_CONFIG", "FlakyDecode", "tiny_llama"]
