"""The global KV plane in the port (ray_tpu_torch/serve/kvplane.py, the
pool's tier hooks in models/kvcache.py, the conductor's prefix
directory) against the JAX package's, on the CPU: Llama tiny in fp32,
KV blocks of 4 tokens.

Twins of tests/test_kvplane.py: the four HostArena cases (each run on
both packages' arenas, their stats compared), the pool's tier-2 round
trip (int8 byte for byte, fp within the int8 tolerance), tier-3 export /
import across pools, namespace isolation, outputs unchanged under pool
pressure and under an evict_storm, the storm's validation, and the
cluster cases (the directory's atomic commit, its TTL reap and GC with
the TTL as an argument, router directory routing, the fetcher's caller
attribution) as checks of `_private/serve_checks.py` in a driver of
their own. Parity: `prefix_digests`, an int8 pool's payload and export
byte for byte with JAX's for the same rows (fp32 within the fp32 op
tolerance), a JAX export adopted by a port pool, the arena's LRU and
byte accounting under one script. The speculation discount of the
autoscaler's DisaggPolicy (serve/autoscale.py), each case on both
packages' policies, their decisions compared.

test_all_surfaces_report_consistent_numbers is serve_checks.port_disagg_
one_set_of_numbers, run by tests/test_torch_disagg.py: its state-API,
timeline and Prometheus legs, and its CLI and dashboard legs
(`kvplane --json` and `/api/kvplane`, totals and directory).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import kvcache as jkv
from ray_tpu.models.engine import _prefill_paged as j_prefill_paged
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import llama_init as jllama_init
from ray_tpu.resilience.chaos import ChaosAction as JChaosAction
from ray_tpu.serve import kvplane as jkvp
from ray_tpu_torch._private import isolated, serve_checks
from ray_tpu_torch.models import kvcache as tkv
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.resilience.chaos import ChaosAction
from ray_tpu_torch.serve import kvplane as tkvp
from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                        PrefillServer)

JCFG = dataclasses.replace(JLlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
BS = serve_checks.BS
CLUSTER = {"num_cpus": 4, "_system_config": serve_checks.SYSTEM_CONFIG}
CHECKS = {name: CLUSTER for name in (
    "kvplane_directory_atomic_commit_and_namespace_isolation",
    "kvplane_directory_ttl_reap_and_gc",
    "kvplane_router_directory_hit_and_holder_death_fallback",
    "kvplane_chunk_fetcher_caller_attribution")}
WIRE = ("qk", "qv", "sk", "sv")


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.fixture(scope="module")
def models():
    jp = jllama_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_kvplane_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_router_directory_streams_match_jax(outcomes):
    """The directory check's streams equal the JAX engine's on its
    weights (a directory hit and a fallback serve the same tokens)."""
    ok, text = outcomes[
        "kvplane_router_directory_hit_and_holder_death_fallback"]
    assert ok, text
    got = json.loads(text)
    _, params = serve_checks.tiny_llama()
    from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
    from ray_tpu_torch.tree import tree_map

    jp = jax.tree.map(jnp.asarray, tree_map(lambda p: p.numpy(), params))
    eng = JEngine(jp, JCFG, max_batch=2, prefix_cache=False)
    try:
        want = [[int(t) for t in eng.generate(p, 4)]
                for p in (got["prompt"], got["ghost"])]
    finally:
        eng.stop()
    assert got["streams"] == want


# ------------------------------------------------- HostArena (tier 2)

def _fake_payload(digest: bytes, toks, *, ns=None, partial=False,
                  parent: bytes = b"parent", seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(toks)
    key = ("partial", parent, tuple(toks)) if partial else ("full", digest)
    return {"index_key": key, "tokens": tuple(toks), "filled": n, "ns": ns,
            "parent_digest": parent,
            "qk": rng.integers(-127, 127, (2, n, 2, 4)).astype(np.int8),
            "qv": rng.integers(-127, 127, (2, n, 2, 4)).astype(np.int8),
            "sk": rng.random((2, 1, 2, 4)).astype(np.float32),
            "sv": rng.random((2, 1, 2, 4)).astype(np.float32)}


def _size(p):
    return sum(int(p[f].nbytes) for f in WIRE)


def _both(script):
    """Run `script(arena_cls)` on the port's and the JAX package's
    HostArena; the port's result, after checking it equals JAX's."""
    got, want = script(tkvp.HostArena), script(jkvp.HostArena)
    assert got == want
    return got


def test_arena_roundtrip_pops_bit_identical_with_collision_guard():
    def script(cls):
        arena = cls(max_bytes=1 << 20, replica="unit")
        p = _fake_payload(b"d1", (1, 2, 3, 4))
        arena.accept(dict(p))
        out = [arena.take_full(b"d1", (9, 9, 9, 9)) is None]
        got = arena.take_full(b"d1", (1, 2, 3, 4))
        out.append(all(np.array_equal(got[f], p[f]) for f in WIRE))
        out.append(got["tokens"] == p["tokens"])
        out.append(arena.take_full(b"d1", (1, 2, 3, 4)) is None)
        st = arena.stats()
        kinds = [e["kind"] for e in arena.drain_events()]
        return out, st, kinds

    out, st, kinds = _both(script)
    assert all(out)
    assert st["spills"] == 1 and st["tier2_hits"] == 1
    assert st["tier2_probes"] == 3 and st["tier2_reused_tokens"] == 4
    assert st["entries"] == 0 and st["bytes"] == 0
    assert kinds == ["spill", "tier2_hit"]


def test_arena_lru_byte_bound_and_oversize_reject():
    size = _size(_fake_payload(b"a", (1, 2, 3, 4)))

    def script(cls):
        arena = cls(max_bytes=2 * size, replica="unit")
        arena.accept(_fake_payload(b"a", (1, 2, 3, 4)))
        arena.accept(_fake_payload(b"b", (5, 6, 7, 8)))
        arena.accept(_fake_payload(b"c", (9, 10, 11, 12)))  # evicts "a"
        st = arena.stats()
        gone = arena.take_full(b"a", (1, 2, 3, 4)) is None
        kept = arena.take_full(b"b", (5, 6, 7, 8)) is not None
        tiny = cls(max_bytes=size - 1, replica="unit")
        tiny.accept(_fake_payload(b"x", (1, 2, 3, 4)))
        return st, gone, kept, tiny.stats()

    st, gone, kept, tiny = _both(script)
    assert st["arena_evictions"] == 1 and st["entries"] == 2
    assert st["bytes"] == 2 * size and gone and kept
    assert tiny["spills"] == 0 and tiny["entries"] == 0


def test_arena_partial_probe_longest_match_within_budget():
    def script(cls):
        arena = cls(max_bytes=1 << 20, replica="unit")
        arena.accept(_fake_payload(b"root", (7, 8), partial=True,
                                   parent=b"root"))
        arena.accept(_fake_payload(b"root", (7, 8, 9), partial=True,
                                   parent=b"root"))
        a = arena.take_partial(b"root", [7, 8, 9, 10], budget=3)
        b = arena.take_partial(b"root", [7, 8, 9, 10], budget=2)
        arena.accept(_fake_payload(b"root", (7, 9), partial=True,
                                   parent=b"root"))
        c = arena.take_partial(b"root", [7, 8], budget=4)
        return a["tokens"], b["tokens"], c, arena.stats()

    a, b, c, _ = _both(script)
    assert a == (7, 8, 9) and b == (7, 8) and c is None


def test_arena_give_back_and_request_attribution():
    p = _fake_payload(b"d", (1, 2, 3, 4))
    size = _size(p)

    def script(cls):
        arena = cls(max_bytes=1 << 20, replica="unit")
        arena.accept(dict(p))
        arena.begin_request()
        got = arena.take_full(b"d", (1, 2, 3, 4))
        acc = arena.end_request()
        acc_ms_ok = acc.pop("ms") >= 0.0
        reset = arena.end_request()["blocks"]
        spills = arena.stats()["spills"]
        arena.give_back(got)
        st = arena.stats()
        again = arena.take_full(b"d", (1, 2, 3, 4)) is not None
        return acc, acc_ms_ok, reset, spills, st, again

    acc, ms_ok, reset, spills, st, again = _both(script)
    assert acc == {"blocks": 1, "tokens": 4, "nbytes": size} and ms_ok
    assert reset == 0
    assert st["spills"] == spills and st["entries"] == 1
    assert st["bytes"] == size and again


def test_arena_lru_script_matches_jax():
    """One longer script of accepts, refreshes, probes and give-backs:
    the same hits, evictions and byte counts, step by step."""
    rng = np.random.default_rng(3)
    size = _size(_fake_payload(b"z", (1, 2, 3, 4)))

    def script(cls):
        arena = cls(max_bytes=5 * size, replica="unit")
        trace = []
        for step in range(60):
            d = bytes([int(rng.integers(0, 9))])
            toks = tuple(int(t) for t in rng.integers(0, 3, 4))
            op = int(rng.integers(0, 4))
            if op <= 1:
                arena.accept(_fake_payload(d, toks, seed=step))
            elif op == 2:
                got = arena.take_full(d, toks)
                trace.append(None if got is None else got["tokens"])
                if got is not None and step % 3 == 0:
                    arena.give_back(got)
            else:
                got = arena.take_partial(d, list(toks), 4)
                trace.append(None if got is None else got["tokens"])
            st = arena.stats()
            trace.append((st["entries"], st["bytes"],
                          st["arena_evictions"], st["tier2_hits"]))
        return trace

    state = rng.bit_generator.state
    got = script(tkvp.HostArena)
    rng.bit_generator.state = state
    assert got == script(jkvp.HostArena)


# -------------------------------------- pool-level tier-2 round trip

def _rows(jp, prompt):
    """The prompt's filled window from the JAX prefill, as numpy."""
    empty = jnp.zeros((JCFG.num_layers, 0, JCFG.num_kv_heads,
                       JCFG.head_dim), jnp.float32)
    _, ck, cv = j_prefill_paged(jp, jnp.asarray(prompt)[None], JCFG,
                                empty, empty)
    return np.asarray(ck), np.asarray(cv)


def _filled_pool(rows, prompt, *, int8, num_blocks=16,
                 arena_bytes=64 << 20, jax_side=False):
    """A pool of either package with `prompt` committed from the same
    rows and an arena attached."""
    ck, cv = rows
    if jax_side:
        kv = jkv.PagedKVCache(JCFG, block_size=BS, num_blocks=num_blocks,
                              int8=int8)
        arena = jkvp.HostArena(max_bytes=arena_bytes, replica="unit")
        ck, cv = jnp.asarray(ck), jnp.asarray(cv)
    else:
        kv = tkv.PagedKVCache(TCFG, block_size=BS, num_blocks=num_blocks,
                              int8=int8, device="cpu")
        arena = tkvp.HostArena(max_bytes=arena_bytes, replica="unit")
        ck, cv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    kv.attach_arena(arena)
    m = kv.lookup(prompt, max_tokens=len(prompt) - 1)
    kv.release(kv.commit(prompt, ck, cv, m))
    return kv, arena


def test_pool_spill_readopt_bit_identical_int8(models):
    """Evict a committed chain into the arena, walk the lookup back
    through it: the re-exported int8 bytes, scales and digest are what
    was there before."""
    jp, _ = models
    prompt = np.arange(101, 117, dtype=np.int32)  # 4 full blocks
    kv, arena = _filled_pool(_rows(jp, prompt), prompt, int8=True)
    before = kv.export_prefix(prompt)
    assert before is not None and before[1] == 16
    assert kv.force_evict(100) == 4
    assert kv.export_prefix(prompt) is None
    st = arena.stats()
    assert st["spills"] == 4 and st["entries"] == 4
    m = kv.lookup(prompt, max_tokens=16)
    assert m.outcome == "hit" and m.tokens == 16
    kv.release(m.bids)
    after = kv.export_prefix(prompt)
    assert after is not None and after[1] == 16 and after[2] == before[2]
    for f in (*WIRE, "tokens"):
        assert np.array_equal(after[0][f], before[0][f]), f
    st = arena.stats()
    assert st["tier2_hits"] == 4 and st["tier2_reused_tokens"] == 16
    assert st["entries"] == 0


def test_pool_spill_readopt_fp_within_tolerance(models):
    jp, _ = models
    prompt = np.arange(201, 213, dtype=np.int32)  # 3 full blocks
    rows = _rows(jp, prompt)
    kv, arena = _filled_pool(rows, prompt, int8=False)
    assert kv.force_evict(100) == 3
    assert arena.stats()["spills"] == 3
    m = kv.lookup(prompt, max_tokens=12)
    assert m.outcome == "hit" and m.tokens == 12
    gk, _ = kv.gather(m)
    ref = rows[0][:, :12]
    assert np.abs(gk.numpy() - ref).max() / (np.abs(ref).max() + 1e-9) \
        < 0.05
    kv.release(m.bids)


def test_tier3_export_import_bit_identical_across_pools(models):
    """Export from A, adopt into a fresh B, re-export: the same arrays
    and digest; the adopted prefix makes B's lookup a hit; a prompt the
    packed tokens do not prefix adopts nothing."""
    jp, _ = models
    prompt = np.arange(301, 313, dtype=np.int32)
    kv_a, _ = _filled_pool(_rows(jp, prompt), prompt, int8=True)
    packed, n_tokens, digest_hex = kv_a.export_prefix(prompt)
    assert n_tokens == 12 and packed["qk"].shape[0] == 3
    kv_b = tkv.PagedKVCache(TCFG, block_size=BS, num_blocks=16, int8=True,
                            device="cpu")
    assert kv_b.import_prefix(prompt, packed) == 3
    packed_b, n_b, dig_b = kv_b.export_prefix(prompt)
    assert n_b == 12 and dig_b == digest_hex
    for f in (*WIRE, "tokens"):
        assert np.array_equal(packed_b[f], packed[f]), f
    m = kv_b.lookup(prompt, max_tokens=11)
    assert m.tokens == 8 and m.outcome == "hit"
    kv_b.release(m.bids)
    kv_c = tkv.PagedKVCache(TCFG, block_size=BS, num_blocks=16, int8=True,
                            device="cpu")
    assert kv_c.import_prefix(np.arange(401, 413, dtype=np.int32),
                              packed) == 0


def test_namespace_isolation_across_tiers(models):
    jp, _ = models
    prompt = np.arange(481, 497, dtype=np.int32)
    kv, arena = _filled_pool(_rows(jp, prompt), prompt, int8=True)
    assert tkv.prefix_digests(prompt, BS, None) \
        != tkv.prefix_digests(prompt, BS, "tenantA|v1")
    assert kv.export_prefix(prompt, namespace="tenantA|v1") is None
    kv.force_evict(100)
    m_other = kv.lookup(prompt, max_tokens=16, namespace="tenantA|v1")
    assert m_other.tokens == 0 and m_other.outcome == "miss"
    assert arena.stats()["tier2_hits"] == 0
    m_same = kv.lookup(prompt, max_tokens=16)
    assert m_same.tokens == 16
    kv.release(m_same.bids)


# ------------------------------------------- parity with the JAX pool

@pytest.mark.parametrize("namespace", [None, "tenantA|v1", ""])
def test_prefix_digests_match_jax(namespace):
    toks = np.random.default_rng(1).integers(0, 50000, 70)
    for bs, mb in ((4, 32), (16, 3), (16, 32)):
        assert tkvp.prefix_digests(toks, bs, namespace, mb) \
            == jkvp.prefix_digests(toks, bs, namespace, mb)


def test_int8_payload_bytes_match_jax(models):
    """The same rows committed to both packages' int8 pools: the export,
    and each spilled block's payload in the arena, are byte for byte
    JAX's; a JAX export adopted by a port pool re-exports the same
    bytes."""
    jp, _ = models
    prompt = np.arange(451, 465, dtype=np.int32)  # 3 blocks + a tail
    rows = _rows(jp, prompt)
    kv, arena = _filled_pool(rows, prompt, int8=True)
    jkvc, jarena = _filled_pool(rows, prompt, int8=True, jax_side=True)
    got, want = kv.export_prefix(prompt), jkvc.export_prefix(prompt)
    assert got[1:] == want[1:]
    for f in (*WIRE, "tokens"):
        assert got[0][f].dtype == want[0][f].dtype
        assert got[0][f].tobytes() == want[0][f].tobytes(), f
    assert kv.force_evict(100) == jkvc.force_evict(100) == 4
    mine = {p["index_key"]: p for p in arena._entries.values()}
    theirs = {p["index_key"]: p for p in jarena._entries.values()}
    assert set(mine) == set(theirs)
    for key, p in mine.items():
        for f in WIRE:
            assert p[f].shape == theirs[key][f].shape
            assert p[f].tobytes() == np.asarray(theirs[key][f]).tobytes()
        for f in ("tokens", "filled", "ns", "parent_digest"):
            assert p[f] == theirs[key][f], f
    assert arena.stats() == jarena.stats()
    fresh = tkv.PagedKVCache(TCFG, block_size=BS, num_blocks=16, int8=True,
                             device="cpu")
    assert fresh.import_prefix(prompt, want[0]) == 3
    again = fresh.export_prefix(prompt)
    for f in WIRE:
        assert again[0][f].tobytes() == want[0][f].tobytes(), f


def test_fp_payload_within_tolerance_of_jax(models):
    """An fp32 pool's payload (quantized on the way out) against JAX's
    for the same rows: scales within the fp32 tolerance, int8 values at
    most one step apart, the dequantized rows within the int8 step."""
    jp, _ = models
    prompt = np.arange(471, 483, dtype=np.int32)
    rows = _rows(jp, prompt)
    kv, _ = _filled_pool(rows, prompt, int8=False)
    jkvc, _ = _filled_pool(rows, prompt, int8=False, jax_side=True)
    got, want = kv.export_prefix(prompt), jkvc.export_prefix(prompt)
    assert got[1:] == want[1:]
    for s in ("sk", "sv"):
        np.testing.assert_allclose(got[0][s], want[0][s], rtol=2e-4,
                                   atol=2e-5)
    for q, s in (("qk", "sk"), ("qv", "sv")):
        assert np.abs(got[0][q].astype(np.int32)
                      - want[0][q].astype(np.int32)).max() <= 1
        np.testing.assert_allclose(got[0][q] * got[0][s],
                                   want[0][q] * want[0][s], rtol=0,
                                   atol=float(want[0][s].max()) + 2e-5)


# ------------------------------------ outputs under pressure (e2e)

def _colocated_int8(tp):
    return ContinuousBatchingEngine(tp, TCFG, max_batch=4, kv_block_size=BS,
                                    kv_pool_blocks=32, kv_int8=True)


def test_outputs_bit_identical_under_pool_pressure(models):
    """A prefill tier whose int8 pool is too small for the working set
    (evictions, spills, re-adoptions) serves what a single-tier engine
    holding everything serves."""
    _, tp = models
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=8,
                       kv_int8=True, kvplane=True,
                       kvplane_arena_bytes=64 << 20, device="cpu")
    dec = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    colo = _colocated_int8(tp)
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=4,
                          affinity_tokens=BS)
    prompts = [list(range(10 * i + 1, 10 * i + 13)) for i in range(4)]
    try:
        for p in prompts + prompts:
            assert router.generate(p, 5) == colo.generate(p, 5), p
    finally:
        dec.stop()
        colo.stop()
    kst = pf.kvplane_stats()
    assert kst["spills"] > 0 and kst["tier2_hits"] > 0, kst
    assert kst["tier2_reused_tokens"] > 0


def test_evict_storm_absorbed_by_arena_outputs_unchanged(models):
    """A storm before request 2's lookup: the arena catches every victim
    and every output stays the single-tier engine's."""
    _, tp = models
    plan = json.dumps([{"action": "evict_storm", "role": "prefill",
                        "blocks": 6, "at": "request:2"}])
    pf = PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=32,
                       kv_int8=True, kvplane=True,
                       kvplane_arena_bytes=64 << 20, chaos=plan,
                       device="cpu")
    dec = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    colo = _colocated_int8(tp)
    router = DisaggRouter(decode=[dec], prefill=[pf], max_queue_depth=4,
                          affinity_tokens=BS)
    base = list(range(401, 413))  # ids within Llama tiny's vocabulary
    try:
        for p in (base, base, base + [99]):
            assert router.generate(p, 5) == colo.generate(p, 5), p
    finally:
        dec.stop()
        colo.stop()
    kst = pf.kvplane_stats()
    assert kst["evict_storms"] == 1 and kst["storm_evicted_blocks"] >= 1
    assert kst["spills"] >= kst["storm_evicted_blocks"]
    assert kst["tier2_hits"] > 0


@pytest.mark.parametrize("cls", [ChaosAction, JChaosAction],
                         ids=["port", "jax"])
def test_evict_storm_action_validation(cls):
    a = cls.from_dict({"action": "evict_storm", "role": "prefill",
                       "blocks": 3, "at": "request:2"})
    assert a.blocks == 3 and a.at_spec() == ("request", 2)
    with pytest.raises(ValueError):
        cls.from_dict({"action": "evict_storm", "role": "prefill",
                       "at": "request:1"})
    with pytest.raises(ValueError):
        cls.from_dict({"action": "evict_storm", "role": "decode",
                       "blocks": 2, "at": "request:1"})


# ------------------------------- speculation-aware autoscaler demand

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_speculation_discount_never_over_scales(pkg):
    """The decode backlog is divided by the measured tokens per verify
    step before the policy sizes the tier; no signal (or a factor <= 1)
    leaves every decision unchanged. Both packages decide the same."""
    from ray_tpu.serve import autoscale as jas
    from ray_tpu_torch.serve import autoscale as tas

    pol = (tas if pkg == "port" else jas).DisaggPolicy(target_p99_ms=500.0)
    other = (jas if pkg == "port" else tas).DisaggPolicy(target_p99_ms=500.0)
    base = {"queue_depth_p99": 12.0, "decode_cap_per_replica": 4,
            "decode_busy_p99": 4.0}
    want_up = pol.desired_decode(dict(base), 1)
    assert want_up[0] == 3
    n_spec, _ = pol.desired_decode(dict(base, spec_tokens_per_verify=3.0), 1)
    assert n_spec == 1 and n_spec <= want_up[0]
    n_mid, reason_mid = pol.desired_decode(
        dict(base, spec_tokens_per_verify=2.0), 1)
    assert n_mid == 2 < want_up[0]
    assert "speculation" in reason_mid
    for f in (None, 0.0, 1.0, 0.6):
        sig = dict(base)
        if f is not None:
            sig["spec_tokens_per_verify"] = f
        assert pol.desired_decode(sig, 1) == want_up
        assert other.desired_decode(dict(sig), 1) == want_up
    assert other.desired_decode(dict(base, spec_tokens_per_verify=2.0),
                                1) == (n_mid, reason_mid)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_speculation_discount_spares_queue_not_busy_slots(pkg):
    """Only queued demand is discounted: busy slots block a scale-down
    at any factor, a queue-only backlog may drain."""
    from ray_tpu.serve import autoscale as jas
    from ray_tpu_torch.serve import autoscale as tas

    pol = (tas if pkg == "port" else jas).DisaggPolicy(target_p99_ms=500.0)
    busy = {"decode_busy_p99": 10.0, "decode_cap_per_replica": 4,
            "queue_depth_p99": 0.0, "spec_tokens_per_verify": 4.0}
    n, _ = pol.desired_decode(dict(busy), 3)
    assert n == 3
    queued = {"decode_cap_per_replica": 4, "queue_depth_p99": 10.0,
              "spec_tokens_per_verify": 4.0}
    n2, reason2 = pol.desired_decode(queued, 3)
    assert n2 == 2, reason2
