"""Disaggregated prefill / decode serving in the port
(ray_tpu_torch/serve/disagg.py) against the JAX package's, on the CPU:
Llama tiny in fp32, KV blocks of 4 tokens, JAX parameters carried over by
`from_jax_params`, every server at ``device="cpu"``.

Twins of tests/test_disagg.py: the cross-replica transfer through a
prefill ACTOR and a decode ACTOR (a check of
`_private/serve_checks.py`, run in a driver process of its own by
`isolated.run_checks`; its streams are held against the JAX engine on
the check's weights), the colocated fallback and the router's shedding.
Parity: the streams of in-process tiers equal the JAX DisaggRouter's for
hit, partial and miss outcomes; the prefill record, DecodeServer.stats()
and DisaggRouter.stats() carry the JAX keys; the KV rows a transfer
carries equal JAX's within the fp32 tolerance; the prefill-affinity
choice is the JAX router's replica. Port checks: a server asked for CUDA
without CUDA raises; a decode replica runs no prefill; one set of
numbers across the state views, the stats and the timeline.

Not twinned: test_serve_router_sheds_with_max_queued_requests waits for
the port of serve/ (deployments and their Router),
and test_load_harness_smoke_records_and_sheds for bench_serve.py.
test_all_surfaces_report_consistent_numbers is
`port_disagg_one_set_of_numbers`: its state-API, timeline and
Prometheus legs, and its CLI and dashboard legs (`disagg`, `kvplane`
and `servefault --json` and their routes equal to the state views).
"""
from __future__ import annotations

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import llama_init as jllama_init
from ray_tpu.serve import disagg as jdisagg
from ray_tpu_torch._private import isolated, serve_checks
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                        PrefillServer)
from ray_tpu_torch.serve.handle import RequestShedError
from ray_tpu_torch.tree import tree_map

JCFG = dataclasses.replace(JLlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
BS = serve_checks.BS
CLUSTER = {"num_cpus": 4, "_system_config": serve_checks.SYSTEM_CONFIG}
CHECKS = {name: CLUSTER for name in (
    "disagg_cross_replica_transfer_bit_identical_no_full_copy",
    "port_disagg_one_set_of_numbers")}
BASE = [1, 2, 3, 4, 5, 6, 7, 8]
# miss, hit (suffix within a block), partial (a 5-token tail), sub-block
PROMPTS = [BASE, BASE, BASE + [9, 10, 11, 12, 13], [5, 5, 5]]


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.fixture(scope="module")
def models():
    jp = jllama_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_streams(jparams, prompts, new):
    eng = JEngine(jparams, JCFG, max_batch=4, kv_block_size=BS,
                  kv_pool_blocks=32)
    try:
        return [[int(t) for t in eng.generate(p, new)] for p in prompts]
    finally:
        eng.stop()


def _engine(tp, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_pool_blocks", 32)
    return ContinuousBatchingEngine(tp, TCFG, **kw)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_disagg_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_cross_replica_transfer_bit_identical_no_full_copy(outcomes):
    """The actors' streams (equal to the port's colocated engine in the
    check) equal the JAX engine's on the check's weights."""
    ok, text = outcomes[
        "disagg_cross_replica_transfer_bit_identical_no_full_copy"]
    assert ok, text
    _, params = serve_checks.tiny_llama()
    jp = jax.tree.map(jnp.asarray, tree_map(lambda p: p.numpy(), params))
    assert json.loads(text)["streams"] == _jax_streams(jp, PROMPTS, 6)


def test_colocated_fallback_is_the_plain_engine_path(models):
    """No prefill tier: the router is the colocated engine, the same
    tokens as the engine and the JAX router, no transfer."""
    jp, tp = models
    eng = _engine(tp)
    router = DisaggRouter(colocated=eng, max_queue_depth=4)
    jeng = JEngine(jp, JCFG, max_batch=4, kv_block_size=BS,
                   kv_pool_blocks=32)
    jrouter = jdisagg.DisaggRouter(colocated=jeng, max_queue_depth=4)
    try:
        p = [21, 22, 23, 24, 25]
        direct = eng.generate(p, 5)
        routed = router.generate(p, 5)
        assert routed == direct == jrouter.generate(p, 5)
        st = router.stats()
        assert st["mode"] == "colocated"
        assert st["dispatched"] == 1 and st["shed"] == 0
        assert eng.adopted == 0
        assert set(st) == set(jrouter.stats())
    finally:
        eng.stop()
        jeng.stop()


def test_disagg_router_sheds_before_queue_is_unbounded(models):
    """One decode slot and queue depth 1: arrivals past the bound are
    shed with the retry-after hint, and the pending high-water never
    passes capacity + depth."""
    _, tp = models
    eng = _engine(tp, max_batch=1)
    router = DisaggRouter(colocated=eng, max_queue_depth=1,
                          retry_after_s=0.25)
    router.generate([1, 2, 3], 2)
    n = 6
    results = {"ok": 0, "shed": 0}
    hints = []
    lock = threading.Lock()

    def one(i):
        try:
            router.generate([1, 2, 3 + i], 8)
            with lock:
                results["ok"] += 1
        except RequestShedError as e:
            with lock:
                results["shed"] += 1
                hints.append((e.retry_after_s, e.cause))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        eng.stop()
    st = router.stats()
    assert results["shed"] >= 1 and results["ok"] >= 1
    assert results["ok"] + results["shed"] == n
    assert st["shed"] == results["shed"]
    assert st["max_pending"] <= 2
    assert all(h == (0.25, "capacity") for h in hints)


def test_streams_and_records_match_jax_router(models):
    """In-process tiers of both packages on the same weights: the same
    streams for hit, partial and miss, the same prefix-cache outcomes,
    and the same keys in every record and stats() both fill; the KV rows
    of a transfer within the fp32 tolerance of JAX's."""
    jp, tp = models
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    dec = DecodeServer(tp, TCFG, max_batch=4, device="cpu")
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=4,
                          affinity_tokens=BS)
    jpf = jdisagg.PrefillServer(jp, JCFG, kv_block_size=BS,
                                kv_pool_blocks=32)
    jdec = jdisagg.DecodeServer(jp, JCFG, max_batch=4)
    jrouter = jdisagg.DisaggRouter(decode=[jdec], prefill=[jpf],
                                   max_queue_depth=4, affinity_tokens=BS)
    try:
        for p in PROMPTS:
            assert router.generate(p, 6) == jrouter.generate(p, 6), p
        rec = pf.prefill(BASE + [9])
        jrec = jpf.prefill(BASE + [9])
        assert set(rec) == set(jrec)
        for k in ("plen", "first_token", "outcome", "reused_tokens",
                  "prompt_tokens"):
            assert rec[k] == jrec[k], k
        assert rec["score"] == pytest.approx(jrec["score"], rel=2e-4,
                                             abs=2e-5)
        for got, want in zip(rec["kv_inline"], jrec["kv_inline"]):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-4, atol=2e-5)
        assert dec.decode_from(rec, 4) == jdec.decode_from(jrec, 4)
        pst, jpst = pf.stats(), jpf.stats()
        assert set(pst) == set(jpst)
        assert set(pst["prefix_cache"]) == set(jpst["prefix_cache"])
        for k in ("prefills", "prefilled_tokens", "reused_tokens",
                  "published_transfers", "published_bytes"):
            assert pst[k] == jpst[k], k
        for k in ("hits", "partial_hits", "misses", "reused_tokens"):
            assert pst["prefix_cache"][k] == jpst["prefix_cache"][k], k
        dst, jdst = dec.stats(), jdec.stats()
        assert set(dst) == set(jdst)
        for k in ("transfers", "decoded_tokens", "adopted"):
            assert dst[k] == jdst[k], k
        rst, jrst = router.stats(), jrouter.stats()
        assert set(rst) == set(jrst)
        for k in ("dispatched", "completed", "shed", "max_pending",
                  "failovers", "sheds_by_cause"):
            assert rst[k] == jrst[k], k
        assert set(pf.kvplane_stats()) == set(jpf.kvplane_stats())
        assert set(router.kvplane_stats()) == set(jrouter.kvplane_stats())
        assert set(router.servefault_stats()) \
            == set(jrouter.servefault_stats())
    finally:
        dec.stop()
        jdec.stop()


def test_prefill_affinity_picks_the_jax_replica(models):
    """The same prompts hash to the same prefill replica index in both
    routers (the stable hash of the first affinity_tokens), with and
    without a tenant."""
    jp, tp = models
    pfs = [PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=8,
                         device="cpu") for _ in range(3)]
    jpfs = [jdisagg.PrefillServer(jp, JCFG, kv_block_size=BS,
                                  kv_pool_blocks=8) for _ in range(3)]
    dec = DecodeServer(tp, TCFG, max_batch=1, device="cpu")
    jdec = jdisagg.DecodeServer(jp, JCFG, max_batch=1)
    try:
        router = DisaggRouter(decode=[dec], prefill=pfs, affinity_tokens=6)
        jrouter = jdisagg.DisaggRouter(decode=[jdec], prefill=jpfs,
                                       affinity_tokens=6)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 500, n).tolist()
                   for n in rng.integers(3, 20, 24)]
        picks = []
        for p in prompts:
            for tenant in (None, "t1"):
                rep, _ = router._pick_prefill(np.asarray(p), None, tenant)
                jrep, _ = jrouter._pick_prefill(np.asarray(p), None, tenant)
                i = [r.rid for r in router._prefill].index(rep.rid)
                assert i == [r.rid for r in jrouter._prefill].index(jrep.rid)
                picks.append(i)
        assert len(set(picks)) > 1  # the prompts spread over replicas
    finally:
        dec.stop()
        jdec.stop()


def test_servers_refuse_cuda_without_cuda(models):
    """A server asked for the card on a machine without CUDA raises: no
    replica serves on the CPU unless the caller says so."""
    _, tp = models
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeServer(tp, TCFG, max_batch=1)


def test_decode_replica_runs_no_prefill(models):
    """prefill_programs() counts the prefills this process ran: a
    prefill moves it by one, an adoption and its decode by none."""
    _, tp = models
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=8,
                       device="cpu")
    dec = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    try:
        before = dec.prefill_programs()
        rec = pf.prefill([7, 8, 9, 10, 11])
        assert dec.prefill_programs() == before + 1
        toks = dec.decode_from(rec, 6)
        assert len(toks) == 6 and toks[0] == rec["first_token"]
        assert dec.prefill_programs() == before + 1
        assert dec.stats()["prefill_programs"] == before + 1
        assert dec.engine.prefill_calls == 0 and dec.engine.adopted == 1
    finally:
        dec.stop()


def test_tenant_streams_through_tiers_match_jax(models):
    """Tenant adapters through both tiers (`lora=` dicts, pools built by
    `build_pool`): a tenant's stream equals the JAX router's for the same
    adapter, differs from the base model's, and is counted per tenant."""
    from ray_tpu.serve import lora as jlora
    from ray_tpu_torch.serve import lora as tlora

    jp, tp = models
    tads = {f"t{i}": tlora.make_lora_adapter(TCFG, rank=3, seed=30 + i,
                                             scale=6.0) for i in range(2)}
    jads = {f"t{i}": jlora.make_lora_adapter(JCFG, rank=3, seed=30 + i,
                                             scale=6.0) for i in range(2)}
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=32,
                       lora=tads, lora_pool_slots=2, lora_rank_max=4,
                       device="cpu")
    dec = DecodeServer(tp, TCFG, max_batch=2, lora=tads, lora_pool_slots=2,
                       lora_rank_max=4, device="cpu")
    router = DisaggRouter(decode=[dec], prefill=[pf], affinity_tokens=BS)
    jpf = jdisagg.PrefillServer(jp, JCFG, kv_block_size=BS,
                                kv_pool_blocks=32, lora=jads,
                                lora_pool_slots=2, lora_rank_max=4)
    jdec = jdisagg.DecodeServer(jp, JCFG, max_batch=2, lora=jads,
                                lora_pool_slots=2, lora_rank_max=4)
    jrouter = jdisagg.DisaggRouter(decode=[jdec], prefill=[jpf],
                                   affinity_tokens=BS)
    p = BASE + [9, 10]
    try:
        base = router.generate(p, 6)
        streams = {t: router.generate(p, 6, tenant=t) for t in tads}
        for t, got in streams.items():
            assert got == jrouter.generate(p, 6, tenant=t), t
        assert base == jrouter.generate(p, 6)
        assert any(got != base for got in streams.values())
        ts = router.tenant_stats()
        assert set(ts) == set(tads)
        assert all(v["completed"] == 1 for v in ts.values())
        assert set(ts["t0"]) == set(jrouter.tenant_stats()["t0"])
    finally:
        dec.stop()
        jdec.stop()


def test_replica_set_drain_remove_and_tier_waker(models):
    """The live replica set: an added decode replica takes requests, a
    draining one takes none and is removed once drained, the last active
    replica cannot drain unless a tier waker is attached, and an arrival
    to an empty tier wakes it and waits for the replica the waker adds."""
    _, tp = models
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=32,
                       device="cpu")
    d1 = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    d2 = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    router = DisaggRouter(decode=[d1], prefill=[pf], affinity_tokens=BS)
    p = [61, 62, 63, 64, 65, 66]
    try:
        want = router.generate(p, 4)
        assert router.add_decode(d2) == d2.server_id
        assert router.begin_drain("decode", d1.server_id)
        assert not router.begin_drain("decode", d2.server_id)  # the last
        assert router.generate(p, 4) == want
        assert d2.stats()["transfers"] == 1 and d1.stats()["transfers"] == 1
        assert router.drained("decode", d1.server_id)
        with pytest.raises(ValueError, match="not draining"):
            router.remove("decode", d2.server_id)
        assert router.remove("decode", d1.server_id) is d1
        assert [r["rid"] for r in router.tier_replicas("decode")] \
            == [d2.server_id]
        woken = []

        def waker(tier):
            woken.append(tier)
            threading.Timer(0.2, router.add_decode, args=(d1,)).start()
            return True

        router.set_tier_waker(waker)
        assert router.begin_drain("decode", d2.server_id, allow_empty=True)
        assert router.remove("decode", d2.server_id) is d2
        assert router.generate(p, 4) == want
        assert woken == ["decode"]
        st = router.stats()
        assert st["tier_wakeups"] == 1 and st["decode_replicas"] == 1
        assert st["completed"] == 3 and st["shed"] == 0
    finally:
        d1.stop()
        d2.stop()
