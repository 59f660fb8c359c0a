"""Multi-tenant LoRA in the PyTorch port against the JAX package's, on the
CPU: `lora_delta`, `lora_targets`, `merge_lora_params`, the `lora=` form
of `llama_decode` / `gpt2_decode` (ragged and verify) on the same pool
stacks, the adapter pool (`serve.lora.AdapterPool`) and the engine's
tenant streams (Llama tiny and GPT-2 tiny at fp32, JAX parameters carried
over by `from_jax_params`).

Tenant adapters are made with scale 6: at rank 3-8 and scale 1 a random
adapter often leaves the tiny model's greedy stream unchanged, which would
make every "tenants differ" check vacuous (the JAX package's own
`test_lora::test_mixed_batch_bit_identity` fails that way on its bf16
tiny model). Tolerances: single ops atol 2e-5 / rtol 2e-4 in fp32 and
2e-2 in bf16 (tests/test_ops.py), a whole model's logits atol/rtol
1e-4."""
from __future__ import annotations

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.models.generate import lora_targets as jlora_targets
from ray_tpu.models.generate import merge_lora_params as jmerge
from ray_tpu.ops.layers import lora_delta as jlora_delta
from ray_tpu.serve import lora as jlora
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.models.generate import (generate, lora_targets,
                                           merge_lora_params)
from ray_tpu_torch.ops.layers import lora_delta
from ray_tpu_torch.serve import lora as tlora
from ray_tpu_torch.tree import tree_map

JCFG = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
JGCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
TGCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype=torch.float32)
TOL = dict(atol=1e-4, rtol=1e-4)
OP_TOL = dict(atol=2e-5, rtol=2e-4)
SCALE = 6.0
PROMPT = list(range(1, 9))


def _t(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def model():
    jp = jllama.llama_init(JCFG, jax.random.PRNGKey(0))
    return jp, _t(jp)


@pytest.fixture(scope="module")
def gpt2_model():
    jp = jgpt2.gpt2_init(JGCFG, jax.random.PRNGKey(3))
    return jp, _t(jp)


@pytest.fixture(scope="module")
def adapters():
    return {f"t{i}": tlora.make_lora_adapter(TCFG, rank=3, seed=10 + i,
                                             scale=SCALE)
            for i in range(4)}


def _pool(adapters, cfg=TCFG, **kw):
    kw.setdefault("device", "cpu")
    return tlora.AdapterPool(cfg, source=tlora.LocalAdapterSource(
        dict(adapters), fetch_delay_s=kw.pop("fetch_delay_s", 0.0)), **kw)


def _jpool(adapters, cfg=JCFG, **kw):
    return jlora.AdapterPool(cfg, source=jlora.LocalAdapterSource(
        dict(adapters)), **kw)


def _engine(params, cfg=TCFG, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("kv_block_size", 4)
    kw.setdefault("kv_pool_blocks", 32)
    return ContinuousBatchingEngine(params, cfg, **kw)


def _reference(tp, prompt, n, cfg=TCFG):
    return generate(tp, cfg, [prompt], max_new_tokens=n)[0].tolist()


# ------------------------------------------------------- ops

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_matches_jax(dtype):
    rng = np.random.default_rng(1)
    b, t, d, r, o = 3, 5, 64, 8, 96
    h, a, bm = (rng.standard_normal(s).astype(np.float32) * m
                for s, m in (((b, t, d), 1.0), ((b, d, r), 0.1),
                             ((b, r, o), 0.1)))
    scale = np.asarray([0.0, 1.0, 6.0], np.float32)
    a[0] = bm[0] = 0.0   # a slot on the null adapter
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlora_delta(*(jnp.asarray(x, jdt) for x in (h, a, bm)),
                       jnp.asarray(scale))
    got = lora_delta(*(torch.from_numpy(x).to(tdt) for x in (h, a, bm)),
                     torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (b, t, o)
    tol = OP_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    assert not got[0].any()  # the null adapter adds an exact zero


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_lora_targets_and_adapter_match_jax(family):
    tcfg, jcfg = (TCFG, JCFG) if family == "llama" else (TGCFG, JGCFG)
    assert lora_targets(tcfg) == jlora_targets(jcfg)
    got = tlora.make_lora_adapter(tcfg, rank=4, seed=5, scale=2.0)
    want = jlora.make_lora_adapter(jcfg, rank=4, seed=5, scale=2.0)
    assert float(got["scale"]) == float(want["scale"])
    for name in got["targets"]:
        for ab in ("a", "b"):
            np.testing.assert_array_equal(got["targets"][name][ab],
                                          want["targets"][name][ab])
    assert tlora.adapter_nbytes(got) == jlora.adapter_nbytes(want)
    assert tlora.adapter_rank(got) == 4
    with pytest.raises(TypeError, match="LoRA"):
        lora_targets(object())


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_merge_lora_params_matches_jax(model, gpt2_model, family):
    jp, tp = model if family == "llama" else gpt2_model
    tcfg, jcfg = (TCFG, JCFG) if family == "llama" else (TGCFG, JGCFG)
    ad = jlora.make_lora_adapter(jcfg, rank=4, seed=3, scale=SCALE)
    jl = {"scale": jnp.float32(SCALE),
          "targets": jax.tree.map(jnp.asarray, ad["targets"])}
    tl = {"scale": torch.tensor(SCALE),
          "targets": tree_map(torch.from_numpy, ad["targets"])}
    want = jmerge(jp, jcfg, jl)
    got = merge_lora_params(tp, tcfg, tl)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OP_TOL)
    name = lora_targets(tcfg)[0][0]
    assert not torch.equal(got["blocks"][0]["attn"][name],
                           tp["blocks"][0]["attn"][name])
    assert got["blocks"][0]["attn"] is not tp["blocks"][0]["attn"]


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_decode_with_lora_matches_jax(model, gpt2_model, adapters, family,
                                      verify):
    """`*_decode(lora=)` on the two packages' pools holding the same
    adapters (three slots: two tenants and the null row), the ragged and
    the verify form: logits and caches. The base slot equals the decode
    without `lora`."""
    jp, tp = model if family == "llama" else gpt2_model
    tcfg, jcfg = (TCFG, JCFG) if family == "llama" else (TGCFG, JGCFG)
    ads = {t: jlora.make_lora_adapter(jcfg, rank=3, seed=20 + i,
                                      scale=SCALE)
           for i, t in enumerate(("a", "b"))}
    tpool = _pool(ads, tcfg, slots=3, rank_max=4)
    jpool = _jpool(ads, jcfg, slots=3, rank_max=4)
    rows = [tpool.acquire(t) for t in ads] + [0]
    assert [jpool.acquire(t) for t in ads] == rows[:2]
    targs = tpool.tick_args(np.asarray(rows))
    jargs = jpool.tick_args(np.asarray(rows, np.int32))
    for name, _, _ in lora_targets(tcfg):
        for got, want in zip(targs[name], jargs[name]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jdec, tdec, jinit, tinit = (
        (jllama.llama_decode, tllama.llama_decode, jllama.init_kv_cache,
         tllama.init_kv_cache) if family == "llama" else
        (jgpt2.gpt2_decode, tgpt2.gpt2_decode, jgpt2.gpt2_init_kv_cache,
         tgpt2.gpt2_init_kv_cache))
    rng = np.random.default_rng(4)
    jcache, tcache = jinit(jcfg, 3), tinit(tcfg, 3, device="cpu")
    for jb, tb in zip(jcache, tcache):
        for name in ("k", "v"):
            fill = rng.standard_normal(tb[name].shape).astype(np.float32)
            jb[name] = jnp.asarray(fill)
            tb[name].copy_(torch.from_numpy(fill))
    base_cache = [{k: v.clone() for k, v in b.items()} for b in tcache]
    tokens = rng.integers(0, jcfg.vocab_size, (3, 3) if verify else (3,))
    pos = np.asarray([7, 30, 12])
    jl, jcache = jdec(jp, jnp.asarray(tokens, jnp.int32), jcfg, jcache,
                      jnp.asarray(pos, jnp.int32), jargs)
    with torch.inference_mode():
        tl, tcache = tdec(tp, torch.from_numpy(tokens), tcfg, tcache,
                          torch.from_numpy(pos), lora=targs)
        base, _ = tdec(tp, torch.from_numpy(tokens), tcfg, base_cache,
                       torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for jb, tb in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(tb[name].numpy(),
                                       np.asarray(jb[name]), **TOL)
    assert torch.equal(tl[2], base[2])          # the null row is exact
    assert (tl[:2] - base[:2]).abs().max() > 1e-3


def test_tick_logits_of_a_tenant_match_merged_weights(model, adapters):
    """The decode of a tenant slot (the per-slot delta) against the plain
    decode on `merge_lora_params` weights: the same function, summed in
    another order."""
    _, tp = model
    pool = _pool(adapters, slots=2)
    row = pool.acquire("t1")
    args = pool.tick_args(np.asarray([row]))
    merged = merge_lora_params(tp, TCFG, pool.adapter_slice(row))
    tokens = torch.tensor([[5, 9, 2]])
    pos = torch.tensor([4])
    with torch.inference_mode():
        c1 = tllama.init_kv_cache(TCFG, 1, device="cpu")
        c2 = tllama.init_kv_cache(TCFG, 1, device="cpu")
        got, _ = tllama.llama_decode(tp, tokens, TCFG, c1, pos, lora=args)
        want, _ = tllama.llama_decode(merged, tokens, TCFG, c2, pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ------------------------------------------------------- the pool

def test_pool_refcount_lru_pin_evict_match_jax(adapters):
    """The same acquire / release sequence on both packages' pools gives
    the same rows, exhaustion and `stats()`."""
    tpool, jpool = _pool(adapters, slots=2), _jpool(adapters, slots=2)

    def both(op, tenant):
        got = getattr(tpool, op)(tenant)
        assert got == getattr(jpool, op)(tenant)
        ts, js = tpool.stats(), jpool.stats()
        for s in (ts, js):
            s.pop("pool_id")
        assert ts == js
        return got

    r0 = both("acquire", "t0")
    assert both("acquire", "t0") == r0 and r0 != 0
    r1 = both("acquire", "t1")
    assert r1 not in (0, r0)
    with pytest.raises(tlora.LoraPoolExhausted):
        tpool.acquire("t2")
    with pytest.raises(jlora.LoraPoolExhausted):
        jpool.acquire("t2")
    both("release", "t1")
    assert both("acquire", "t2") == r1      # t1 evicted, its row reused
    s = tpool.stats()
    assert s["evictions"] == 1 and "t1" not in s["residents"]
    assert s["residents"]["t0"]["ref"] == 2
    both("release", "t0")
    both("release", "t0")
    assert both("acquire", "t0") == r0      # unpinned, still resident
    assert [e["kind"] for e in tpool.drain_events()] == \
        ["page_in", "page_in", "evict", "page_in"]


def test_pool_row_writes_are_in_place(adapters):
    pool = _pool(adapters, slots=2)
    name = pool.targets[0][0]
    stacks = [pool._a[name], pool._b[name], pool._scale]
    ptrs = [x.data_ptr() for x in stacks]
    r0 = pool.acquire("t0")
    r1 = pool.acquire("t1")
    assert [x.data_ptr() for x in (pool._a[name], pool._b[name],
                                   pool._scale)] == ptrs
    assert all(x is y for x, y in zip(stacks, (pool._a[name],
                                               pool._b[name], pool._scale)))
    for row, t in ((r0, "t0"), (r1, "t1")):
        sl = pool.adapter_slice(row)
        want = adapters[t]["targets"][name]["a"]
        np.testing.assert_array_equal(sl["targets"][name]["a"][..., :3],
                                      want)
        assert not sl["targets"][name]["a"][..., 3:].any()  # rank padding
        assert float(sl["scale"]) == SCALE
    assert not pool._a[name][0].any() and float(pool._scale[0]) == 0.0
    # a slice is a copy: a later swap of the row leaves it unchanged
    sl = pool.adapter_slice(r0)
    before = sl["targets"][name]["a"].clone()
    pool.source.publish("t0", adapters["t2"])
    assert pool.refresh("t0")
    assert torch.equal(sl["targets"][name]["a"], before)


def test_pool_rank_ceiling_and_shape_checks(adapters):
    big = tlora.make_lora_adapter(TCFG, rank=9, seed=1)
    wrong = tlora.make_lora_adapter(TGCFG, rank=2, seed=1)
    pool = _pool({"big": big, "wrong": wrong}, slots=2, rank_max=4)
    with pytest.raises(ValueError, match="rank_max"):
        pool.acquire("big")
    with pytest.raises(ValueError, match="no leaf"):
        pool.acquire("wrong")
    s = pool.stats()
    assert s["resident"] == 0 and s["acquires"] == 0
    with pytest.raises(KeyError, match="no adapter"):
        pool.acquire("missing")
    with pytest.raises(ValueError):
        tlora.AdapterPool(TCFG, slots=0, device="cpu")


def test_build_pool(adapters):
    assert tlora.build_pool(TCFG, None) is None
    assert tlora.build_pool(TCFG, False) is None
    pool = tlora.build_pool(TCFG, dict(adapters), slots=2, device="cpu")
    assert isinstance(pool, tlora.AdapterPool) and pool.slots == 2
    assert tlora.build_pool(TCFG, pool) is pool
    src = tlora.LocalAdapterSource(dict(adapters))
    assert tlora.build_pool(TCFG, src, device="cpu").source is src
    # True pages from the weight fabric, which needs a live cluster (the
    # fabric case below runs one)
    with pytest.raises(RuntimeError, match="live cluster"):
        tlora.build_pool(TCFG, True, device="cpu")
    assert tlora.tenant_weights_name("t0") == \
        jlora.tenant_weights_name("t0")


# ------------------------------------------------------- the engine

@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_tenant_streams_match_jax_engine(model, gpt2_model, family):
    """A mixed batch of two tenants and a base request: the streams equal
    the sequential runs, the JAX engine's (same adapters), and the base
    stream equals an engine with no pool; each tenant's stream differs
    from base and from the other tenant's."""
    jp, tp = model if family == "llama" else gpt2_model
    tcfg, jcfg = (TCFG, JCFG) if family == "llama" else (TGCFG, JGCFG)
    # GPT-2 tiny's greedy stream needs a larger delta to move (the JAX
    # package's own GPT-2 LoRA test uses scale 32)
    scale = SCALE if family == "llama" else 32.0
    ads = {f"t{i}": tlora.make_lora_adapter(tcfg, rank=3, seed=10 + i,
                                            scale=scale) for i in range(2)}
    jobs = ("t0", "t1", None)
    eng = _engine(tp, tcfg, lora_pool=_pool(ads, tcfg, slots=3))
    jeng = JEngine(jp, jcfg, max_batch=4, kv_block_size=4,
                   kv_pool_blocks=32, speculate_k=0,
                   lora_pool=_jpool(ads, jcfg, slots=3))
    base = _engine(tp, tcfg)
    try:
        streams = [eng.stream(PROMPT, 8, adapter_id=a) for a in jobs]
        mixed = [list(s) for s in streams]
        seq = [eng.generate(PROMPT, 8, adapter_id=a) for a in jobs]
        want = [jeng.generate(PROMPT, 8, adapter_id=a) for a in jobs]
        plain = base.generate(PROMPT, 8)
        st = eng.kv_stats()
    finally:
        eng.stop()
        jeng.stop()
        base.stop()
    assert mixed == seq == want
    assert mixed[2] == plain == _reference(tp, PROMPT, 8, tcfg)
    assert mixed[0] != mixed[2] and mixed[1] != mixed[2]
    assert mixed[0] != mixed[1]
    assert st["lora"] is True and st["pinned_blocks"] == 0
    assert eng.lora_pool.stats()["pinned"] == 0


def test_tenant_kv_namespace_isolation(model, adapters):
    _, tp = model
    eng = _engine(tp, lora_pool=_pool(adapters, slots=3))
    prompt = list(range(200, 219))
    try:
        kv = eng.kv_cache
        out_a = eng.generate(prompt, 4, adapter_id="t0")
        mid = kv.stats()
        out_b = eng.generate(prompt, 4, adapter_id="t1")
        after = kv.stats()
        assert after["misses"] == mid["misses"] + 1   # t1 never matches t0
        assert after["hits"] == mid["hits"]
        s = eng.stream(prompt, 4, adapter_id="t0")
        assert list(s) == out_a and s.cache_outcome == "hit"
        assert out_a != out_b
        base = eng.stream(prompt, 4)
        assert list(base) == _reference(tp, prompt, 4)
        assert base.cache_outcome == "miss"
    finally:
        eng.stop()


def test_hot_swap_mid_decode_leaves_others_unchanged(model, adapters):
    _, tp = model
    pool = _pool(adapters, slots=3)
    eng = _engine(tp, lora_pool=pool)
    try:
        pool.acquire("t2")
        pool.release("t2")
        v1 = pool.resident_version("t2")
        ref = eng.generate(PROMPT, 10, adapter_id="t3")
        old_t2 = eng.generate(PROMPT, 6, adapter_id="t2")
        it = iter(eng.stream(PROMPT, 10, adapter_id="t3"))
        got = [next(it)]
        pool.source.publish("t2", tlora.make_lora_adapter(
            TCFG, rank=3, seed=99, scale=SCALE))
        assert pool.refresh("t2")
        assert pool.resident_version("t2") == v1 + 1
        got.extend(it)
        assert got == ref
        new_t2 = eng.generate(PROMPT, 6, adapter_id="t2")
        assert new_t2 == eng.generate(PROMPT, 6, adapter_id="t2")
        assert new_t2 != old_t2
        assert pool.stats()["swaps"] == 1
        # the swap listener dropped t2's old namespace
        assert any(e.get("namespace") == "t2@v1"
                   for e in eng.kv_cache.drain_events()
                   if e["kind"] == "invalidate")
    finally:
        eng.stop()


def test_evicted_then_republished_adapter_flushes_stale_kv(model, adapters):
    """A tenant evicted, republished and paged in again arrives at a new
    version: its cached KV of the old one is never spliced under the new
    adapter, and its streams equal a clean engine's on the new one, as in
    the JAX engine."""
    jp, tp = model
    v2 = tlora.make_lora_adapter(TCFG, rank=3, seed=55, scale=SCALE)
    prompt = list(range(300, 319))

    def run(make_engine, make_pool, ref_pool):
        pool = make_pool({"t0": adapters["t0"], "t1": adapters["t1"]})
        eng = make_engine(pool)
        ref = make_engine(ref_pool({"t0": v2}))
        try:
            out1 = eng.generate(prompt, 4, adapter_id="t0")
            eng.generate(prompt, 4, adapter_id="t1")   # evicts t0
            pool.source.publish("t0", v2)
            out2 = eng.generate(prompt, 4, adapter_id="t0")
            return out1, out2, ref.generate(prompt, 4, adapter_id="t0")
        finally:
            eng.stop()
            ref.stop()

    got = run(lambda p: _engine(tp, max_batch=2, lora_pool=p),
              lambda a: _pool(a, slots=1), lambda a: _pool(a, slots=1))
    want = run(lambda p: JEngine(jp, JCFG, max_batch=2, speculate_k=0,
                                 lora_pool=p),
               lambda a: _jpool(a, slots=1), lambda a: _jpool(a, slots=1))
    assert got == want
    out1, out2, ref = got
    assert out2 == ref and out2 != out1


def test_cold_page_in_never_stalls_a_hot_tenant(model, adapters):
    """A cold adapter's slow fetch runs on the submitting thread: the hot
    tenant's tokens keep coming while it pages in."""
    _, tp = model
    delay = 0.5
    eng = _engine(tp, lora_pool=_pool(adapters, slots=3,
                                      fetch_delay_s=delay))
    try:
        eng.generate(PROMPT, 2, adapter_id="t0")
        it = iter(eng.stream(PROMPT, 40, adapter_id="t0"))
        next(it)
        th = threading.Thread(
            target=lambda: eng.generate(PROMPT, 2, adapter_id="t1"))
        th.start()
        gaps, last = [], time.perf_counter()
        for _ in range(30):
            next(it)
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
        th.join(timeout=30)
        assert not th.is_alive()
        list(it)
    finally:
        eng.stop()
    assert max(gaps) < delay * 0.8, max(gaps)


def test_cancel_releases_the_adapter_pin(model, adapters):
    _, tp = model
    pool = _pool(adapters, slots=3)
    eng = _engine(tp, max_batch=1, lora_pool=pool)
    try:
        stream = eng.stream(PROMPT, 80, adapter_id="t0")
        queued = eng.stream(PROMPT, 5, adapter_id="t1")
        it = iter(stream)
        next(it)
        assert eng.cancel_slot(queued) and eng.cancel_slot(stream)
        assert len(list(it)) < 79 and list(queued) == []
        deadline = time.monotonic() + 10
        while eng.cancelled < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.cancelled == 2
        assert pool.stats()["pinned"] == 0
        assert eng.generate(PROMPT, 6) == _reference(tp, PROMPT, 6)
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="lora_pool"):
        _engine(tp, max_batch=1).submit(PROMPT, 2, adapter_id="t0")


def test_speculated_mixed_tenant_batches_equal_unspeculated(model, adapters):
    """Per-slot adapter deltas apply at every verify column: speculated
    mixed batches equal unspeculated ones, and the repeats draft from the
    output memory, which is keyed by adapter."""
    _, tp = model
    rng = np.random.default_rng(29)
    prompts = [rng.integers(1, 500, n).tolist() for n in (9, 14)]
    jobs = [(prompts[0], None), (prompts[1], "t1"), (prompts[0], "t2"),
            (prompts[1], None)]

    def run(k):
        eng = _engine(tp, speculate_k=k,
                      lora_pool=_pool(adapters, slots=4, rank_max=4))
        try:
            streams = [eng.stream(p, 16, adapter_id=t) for p, t in jobs]
            out = [list(s) for s in streams]
            out += [eng.generate(p, 16, adapter_id=t) for p, t in jobs]
            return out, eng.speculation_stats()
        finally:
            eng.stop()

    want, _ = run(0)
    got, st = run(4)
    assert got == want
    assert st["spec_verify_ticks"] > 0 and st["spec_accepted"] > 0
    assert want[1] != want[3] or want[0] != want[2]


def test_tenant_adoption_decodes_under_its_adapter(model, adapters):
    """A tenant's prompt prefilled by one engine (under its adapter) and
    adopted by a LoRA engine with the same pool contents: the stream
    equals the colocated engine's."""
    _, tp = model
    from ray_tpu_torch.models.engine import _prefill_with_cache

    src_eng = _engine(tp, lora_pool=_pool(adapters, slots=2))
    dec = _engine(tp, prefix_cache=False, lora_pool=_pool(adapters, slots=2))
    try:
        want = src_eng.generate(PROMPT, 8, adapter_id="t1")
        pool = src_eng.lora_pool
        row = pool.acquire("t1")
        with torch.inference_mode():
            ck, cv, _, first, score, *_ = _prefill_with_cache(
                tp, TCFG, None, np.asarray([PROMPT]), src_eng._empty_prefix,
                adapter=pool.adapter_slice(row))
        pool.release("t1")
        plen = len(PROMPT)
        got = list(dec.adopt_prefill(plen, first, ck[:, :plen],
                                     cv[:, :plen], 8, score=score,
                                     adapter_id="t1",
                                     prompt_tokens=PROMPT))
        st = dec.kv_stats()
    finally:
        src_eng.stop()
        dec.stop()
    assert got == want
    assert st["adopted"] == 1 and st["prefill_calls"] == 0
    assert dec.lora_pool.stats()["pinned"] == 0


# ------------------------------------------- the weight-fabric source

def test_fabric_source_and_tenant_trainer():
    """tests/test_lora.py's fabric path on a cluster of its own (an
    isolated driver, `fabric_checks.lora_fabric_source_pages_and_hot_
    swaps`): a `TenantLoraTrainer` publishes its adapter every step, a
    pool from `build_pool(lora=True)` pages the newest version in,
    streams as a pool over a LocalAdapterSource of the trainer's
    adapter, and hot-swaps on a third publish's notice."""
    from ray_tpu_torch._private import isolated

    name = "lora_fabric_source_pages_and_hot_swaps"
    outcomes = isolated.run_checks({name: {"num_cpus": 4}}, timeout=200.0)
    for key in (name, isolated.SESSION_ENDED):
        ok, text = outcomes[key]
        assert ok, text
