"""The PyTorch port's paged KV prefix cache, its serving engine and
`stream_generate` against the JAX package's, on the CPU.

Allocator cases run the same operation sequence on both packages' pools
(Llama tiny fp32, 4-token blocks, the same numpy KV fills) and require
the same block tables, matches, `stats()` and gathered KV at every step.
Device ops and int8 blocks and scales are byte-equal to the JAX ops on
the same inputs. Engine cases mirror the JAX package's own
(tests/test_kvcache.py, tests/test_speculate.py) with JAX parameters
carried over by `from_jax_params`: greedy streams equal `generate()` and
the JAX engine's, with the cache on.

Cached against uncached on the CPU: torch's CPU GEMM is not row-stable
across the row count M (M = 1 takes another path, and GPT-2's tied LM
head differs at small M too), so a suffix prefill's logits can differ
from a full prefill's in the last bits (5e-7 here). The streams stay
equal; the logits are held to the fp32 op tolerance, atol 2e-5 / rtol
2e-4 (tests/test_ops.py).

The engine's telemetry push drains the pool's events with no cluster, as
JAX's does; a case that reads them keeps every drained event. In a
cluster (`telemetry_checks.kvcache_all_surfaces_report_consistent_
numbers`), kv_cache_stats(), the prefix-hit events, the
``ray_tpu_kvcache_*`` Prometheus families and the timeline's kvcache
lane carry the engine's own numbers."""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import kvcache as jkv
from ray_tpu.models import llama as jllama
from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.models.engine import _prefill_paged as j_prefill_paged
from ray_tpu.models.generate import stream_generate as jstream_generate
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import kvcache as tkv
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import (ContinuousBatchingEngine,
                                         _prefill_paged)
from ray_tpu_torch.models.generate import generate, stream_generate
from ray_tpu_torch.tree import tree_map

JCFG = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
JGCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
TGCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype=torch.float32)
BS = 4  # block size: small enough for chains and tails
OP_TOL = dict(atol=2e-5, rtol=2e-4)
KV_SHAPE = (JCFG.num_layers, JCFG.max_seq_len, JCFG.num_kv_heads,
            JCFG.d_model // JCFG.num_heads)


@pytest.fixture(scope="module")
def model():
    jp = jllama.llama_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _engine(params, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_pool_blocks", 32)
    return ContinuousBatchingEngine(params, TCFG, **kw)


def _jengine(params, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_pool_blocks", 32)
    return JEngine(params, JCFG, speculate_k=0, **kw)


def _reference(tp, prompt, n, cfg=TCFG):
    return generate(tp, cfg, [prompt], max_new_tokens=n)[0].tolist()


def _fake_kv(seed: int):
    """A seeded single-sequence fill [L, S, H, hd] (the allocator never
    reads KV values)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(KV_SHAPE, dtype=np.float32),
            rng.standard_normal(KV_SHAPE, dtype=np.float32))


class _Both:
    """One pool in each package, driven in lockstep: every call checks
    that both return the same and end with equal `stats()`."""

    def __init__(self, block_size=BS, num_blocks=8, int8=False):
        self.j = jkv.PagedKVCache(JCFG, block_size=block_size,
                                  num_blocks=num_blocks, int8=int8)
        self.t = tkv.PagedKVCache(TCFG, block_size=block_size,
                                  num_blocks=num_blocks, int8=int8,
                                  device="cpu")

    def stats(self):
        sj, st = self.j.stats(), self.t.stats()
        assert st == sj
        return st

    def lookup(self, tokens, max_tokens, namespace=None):
        mj = self.j.lookup(tokens, max_tokens, namespace=namespace)
        mt = self.t.lookup(tokens, max_tokens, namespace=namespace)
        fields = ("bids", "tokens", "full_blocks", "partial_bid",
                  "partial_len", "outcome")
        assert [getattr(mt, f) for f in fields] == \
            [getattr(mj, f) for f in fields]
        self.stats()
        return mj, mt

    def commit(self, tokens, kv, match, namespace=None):
        ck, cv = kv
        tj = self.j.commit(tokens, jnp.asarray(ck), jnp.asarray(cv),
                           match[0], namespace=namespace)
        tt = self.t.commit(tokens, torch.from_numpy(ck),
                           torch.from_numpy(cv), match[1],
                           namespace=namespace)
        assert tt == tj
        self.stats()
        return tt

    def gather(self, match):
        kj, vj = self.j.gather(match[0])
        kt, vt = self.t.gather(match[1])
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        return kt.numpy(), vt.numpy()

    def release(self, table):
        self.j.release(table)
        self.t.release(table)
        return self.stats()

    def pools(self):
        out = [(self.t._pool_k.numpy(), np.asarray(self.j._pool_k)),
               (self.t._pool_v.numpy(), np.asarray(self.j._pool_v))]
        if self.t.int8:
            out += [(self.t._scale_k.numpy(), np.asarray(self.j._scale_k)),
                    (self.t._scale_v.numpy(), np.asarray(self.j._scale_v))]
        return out


# ------------------------------------------------------- digests

@pytest.mark.parametrize("namespace", [None, "tenant-a"])
def test_prefix_digests_match_jax(namespace):
    tokens = np.random.default_rng(1).integers(0, 50000, 70)
    for bs in (4, 16):
        got = tkv.prefix_digests(tokens, bs, namespace=namespace)
        assert got == jkv.prefix_digests(tokens, bs, namespace=namespace)
        assert len(got) == len(tokens) // bs
    assert tkv.prefix_digests(tokens, 4, namespace=namespace,
                              max_blocks=3) == \
        jkv.prefix_digests(tokens, 4, namespace=namespace, max_blocks=3)
    assert tkv.prefix_digests(tokens, 4, "a") != tkv.prefix_digests(
        tokens, 4, "b")


@pytest.mark.parametrize("args", [(None, None, 4, False), (None, None, 4,
                                                            True),
                                  (8, None, 2, True), (None, 40, 4, True),
                                  (24, 0, 3, False)])
def test_resolve_pool_config_matches_jax(args):
    bs, pb, slots, int8 = args
    got = tkv.resolve_pool_config(TCFG, bs, pb, slots=slots, int8=int8)
    assert got == jkv.resolve_pool_config(JCFG, bs, pb, slots=slots,
                                          int8=int8)
    default = tkv.resolve_pool_config(TCFG, slots=4)
    assert tkv.resolve_pool_config(TCFG, slots=4, int8=True) == (
        default[0], 2 * default[1])


# ------------------------------------------------------- allocator

def test_allocator_refcount_sharing_and_gather():
    both = _Both(num_blocks=8)
    tokens = np.arange(1, 9, dtype=np.int32)          # 2 full blocks
    ck, cv = _fake_kv(0)
    miss = both.lookup(tokens, 7)
    assert miss[1].outcome == "miss" and miss[1].tokens == 0
    table = both.commit(tokens, (ck, cv), miss)
    assert len(table) == 2
    st = both.stats()
    assert st["inserted_blocks"] == 2 and st["pinned_blocks"] == 2
    m2 = both.lookup(tokens, 7)
    assert m2[1].tokens == BS and m2[1].outcome == "hit"
    pk, pv = both.gather(m2)
    np.testing.assert_array_equal(pk, ck[:, :BS])
    np.testing.assert_array_equal(pv, cv[:, :BS])
    both.release(table)
    st = both.release(m2[1].bids)
    assert st["pinned_blocks"] == 0 and st["cached_blocks"] == 2
    assert both.lookup(tokens, 7)[1].tokens == BS


def test_allocator_eviction_spares_referenced_blocks():
    both = _Both(num_blocks=2)
    kv = _fake_kv(1)
    tok_a, tok_b, tok_c, tok_d = (np.arange(s, s + 4, dtype=np.int32)
                                  for s in (10, 20, 30, 40))
    table_a = both.commit(tok_a, kv, both.lookup(tok_a, 3))
    table_b = both.commit(tok_b, kv, both.lookup(tok_b, 3))
    assert len(table_a) == len(table_b) == 1
    both.release(table_b)
    table_c = both.commit(tok_c, kv, both.lookup(tok_c, 3))
    assert len(table_c) == 1 and both.stats()["evictions"] == 1
    assert both.lookup(np.concatenate([tok_a, tok_a]), 7)[1].tokens == BS
    assert both.lookup(np.concatenate([tok_b, tok_b]), 7)[1].tokens == 0
    # everything pinned: commit caches nothing
    table_d = both.commit(tok_d, kv, both.lookup(tok_d, 3))
    assert table_d == [] and both.stats()["evictions"] == 1
    assert both.t.drain_events()[0]["kind"] == "evict"


def test_allocator_cow_divergence_after_shared_prefix():
    both = _Both(num_blocks=8)
    base = np.arange(1, 7, dtype=np.int32)             # full + tail of 2
    ck_a, cv_a = _fake_kv(2)
    table_a = both.commit(base, (ck_a, cv_a), both.lookup(base, 5))
    assert len(table_a) == 2 and both.stats()["cow_copies"] == 0
    ext = np.concatenate([base, np.arange(50, 54, dtype=np.int32)])
    shared = (np.arange(JCFG.max_seq_len) < 6)[None, :, None, None]
    ck_b = np.where(shared, ck_a, _fake_kv(3)[0]).astype(np.float32)
    cv_b = ck_b + 1.0
    m_b = both.lookup(ext, 9)
    assert m_b[1].tokens == 6 and m_b[1].partial_bid is not None
    both.commit(ext, (ck_b, cv_b), m_b)
    assert both.stats()["cow_copies"] == 1
    third = np.concatenate([base, np.arange(70, 74, dtype=np.int32)])
    assert both.lookup(third, 9)[1].tokens == 6
    m_b2 = both.lookup(ext, 8)
    assert m_b2[1].tokens == 8
    pk, _ = both.gather(m_b2)
    np.testing.assert_array_equal(pk, ck_b[:, :8])
    for got, want in both.pools():
        np.testing.assert_array_equal(got, want)


def test_allocator_skips_tail_crossing_cache_window():
    both = _Both(block_size=24, num_blocks=8)           # S = 128
    tokens = np.arange(1, 123, dtype=np.int32)          # 5 full + 2
    table = both.commit(tokens, _fake_kv(4), both.lookup(tokens, 121))
    assert len(table) == 5
    m = both.lookup(tokens, 121)
    assert m[1].tokens == 120 and m[1].partial_bid is None
    both.release(table)
    assert both.release(m[1].bids)["pinned_blocks"] == 0


@pytest.mark.parametrize("int8", [False, True])
def test_allocator_sequence_matches_jax(int8):
    """A longer run: shared chains, a widened partial (copy-on-write in
    the full-block loop and in the tail), pool pressure with eviction,
    releases, a forced eviction, a namespaced and a whole invalidation:
    the same tables, stats, gathers and pool bytes on both."""
    both = _Both(num_blocks=8, int8=int8)
    rng = np.random.default_rng(5)
    a, x, y, z, w, b = (rng.integers(1, 500, n).astype(np.int32).tolist()
                        for n in (9, 3, 5, 2, 7, 11))
    prompts = [a, a + x, a + x + y, a + z, a + x[:2] + w, b, a + x + y + z,
               b + z]
    tables = []
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)
        m = both.lookup(p, len(p) - 1)
        if m[1].tokens:
            both.gather(m)
        tables.append(both.commit(p, _fake_kv(10 + i), m))
        while len(tables) > 2:
            both.release(tables.pop(0))
    st = both.stats()
    assert st["cow_copies"] >= 2 and st["evictions"] >= 2
    assert st["hits"] >= 1 and st["partial_hits"] >= 1
    assert both.t.force_evict(2) == both.j.force_evict(2)
    both.stats()
    for got, want in both.pools():
        np.testing.assert_array_equal(got, want)
    both.j.invalidate(namespace="tenant")
    both.t.invalidate(namespace="tenant")
    st = both.stats()
    assert st["invalidations"] == 1 and st["cached_blocks"] > 0
    both.j.invalidate()
    both.t.invalidate()
    st = both.stats()
    assert st["cached_blocks"] == 0 and st["invalidations"] == 2
    for table in tables:
        st = both.release(table)
    assert st["pinned_blocks"] == 0 and st["free_blocks"] == 8
    assert [e["kind"] for e in both.t.drain_events()][-2:] == \
        ["invalidate", "invalidate"]


def test_namespaces_scope_matches_and_invalidation():
    both = _Both(num_blocks=8)
    tokens = np.arange(1, 10, dtype=np.int32)
    both.release(both.commit(tokens, _fake_kv(6),
                             both.lookup(tokens, 8, namespace="a"),
                             namespace="a"))
    for ns, want in ((None, 0), ("b", 0), ("a", 8)):
        m = both.lookup(tokens, 8, namespace=ns)
        assert m[1].tokens == want
        both.release(m[1].bids)
    both.j.invalidate(namespace="b")
    both.t.invalidate(namespace="b")
    assert both.stats()["cached_blocks"] == 3
    both.j.invalidate(namespace="a")
    both.t.invalidate(namespace="a")
    assert both.stats()["cached_blocks"] == 0


# ------------------------------------------------------- device ops

def _ops_inputs(seed=7):
    rng = np.random.default_rng(seed)
    shape = (2, 6, BS, 2, 8)                  # [L, N, bs, H, hd]
    pool_k, pool_v, blk_k, blk_v = (
        rng.standard_normal(s).astype(np.float32)
        for s in (shape, shape, (2, BS, 2, 8), (2, BS, 2, 8)))
    blk_k[:, :, 1, 3] = 0.0                   # a channel whose amax is 0
    # ties that round half to even once scaled: amax 2.5 -> scale 2.5/127
    blk_k[0, :, 0, 0] = [0.5 * 2.5 / 127, 1.5 * 2.5 / 127, -2.5, 0.0]
    return pool_k, pool_v, blk_k, blk_v


def _t(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype):
    return jnp.asarray(a, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp_device_ops_match_jax(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    pk, pv, bk, bv = _ops_inputs()
    t_pk, t_pv = _t(pk, tdt), _t(pv, tdt)
    tkv._write_block(t_pk, t_pv, torch.tensor([3]), _t(bk, tdt)[:, None],
                     _t(bv, tdt)[:, None])
    j_pk, j_pv = jkv._write_block(_j(pk, jdt), _j(pv, jdt), np.int32(3),
                                  _j(bk, jdt), _j(bv, jdt))
    tkv._cow_extend_block(t_pk, t_pv, torch.tensor([5]), torch.tensor([3]),
                          _t(bv, tdt)[:, None], _t(bk, tdt)[:, None], 3)
    j_pk, j_pv = jkv._cow_extend_block(j_pk, j_pv, np.int32(5), np.int32(3),
                                       _j(bv, jdt), _j(bk, jdt),
                                       np.int32(3))
    for got, want in ((t_pk, j_pk), (t_pv, j_pv)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    tg = tkv._gather_prefix(t_pk, t_pv, torch.tensor([5, 3, 0]), 10)
    jg = jkv._gather_prefix(j_pk, j_pv, jnp.asarray([5, 3, 0]), 10)
    ck = np.random.default_rng(8).standard_normal(
        (2, 20, 2, 8)).astype(np.float32)
    rows = torch.tensor([4, 5, 6, 7, 12, 13, 14, 15])
    te = tkv._extract_block(_t(ck, tdt), _t(ck, tdt) + 1, rows, BS)
    je = [jkv._extract_block(_j(ck, jdt), _j(ck, jdt) + 1, np.int32(s), BS)
          for s in (4, 12)]
    for got, want in zip(tg, jg):
        assert got.shape == (2, 10, 2, 8)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    for i in range(2):
        for got, want in zip(te, je[i]):
            np.testing.assert_array_equal(got[:, i].float().numpy(),
                                          np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_device_ops_byte_equal_to_jax(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    _, _, bk, bv = _ops_inputs()
    qt, st = tkv._quantize(_t(bk, tdt))
    # jitted, as every JAX pool write runs it (eager JAX divides by 127
    # where XLA multiplies by its reciprocal)
    qj, sj = jax.jit(jkv._quantize)(_j(bk, jdt))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int8 and st.shape == (2, 1, 2, 8)
    assert float(st[0, 0, 1, 3]) == 1.0       # the all-zero channel

    shape, sshape = (2, 6, BS, 2, 8), (2, 6, 1, 2, 8)
    t_pools = [torch.zeros(shape, dtype=torch.int8) for _ in range(2)] + \
        [torch.zeros(sshape) for _ in range(2)]
    j_pools = [jnp.zeros(shape, jnp.int8) for _ in range(2)] + \
        [jnp.zeros(sshape, jnp.float32) for _ in range(2)]
    tkv._write_block_q(*t_pools, torch.tensor([2]), _t(bk, tdt)[:, None],
                       _t(bv, tdt)[:, None])
    j_pools = jkv._write_block_q(*j_pools, np.int32(2), _j(bk, jdt),
                                 _j(bv, jdt))
    tkv._cow_extend_block_q(*t_pools, torch.tensor([4]), torch.tensor([2]),
                            _t(bv, tdt)[:, None], _t(bk, tdt)[:, None], 2)
    j_pools = jkv._cow_extend_block_q(*j_pools, np.int32(4), np.int32(2),
                                      _j(bv, jdt), _j(bk, jdt), np.int32(2))
    raw = [p[:, 2:3].clone() for p in t_pools]
    tkv._write_block_qraw(*t_pools, torch.tensor([5]), *raw)
    j_pools = jkv._write_block_qraw(*j_pools, np.int32(5),
                                    *[np.asarray(p[:, 2]) for p in j_pools])
    for got, want in zip(t_pools, j_pools):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tg = tkv._gather_prefix_q(*t_pools, torch.tensor([4, 2, 5]), 9, tdt)
    jg = jkv._gather_prefix_q(*j_pools, jnp.asarray([4, 2, 5]), 9, jdt)
    for got, want in zip(tg, jg):
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


# ------------------------------------------------------- int8 pool

def test_int8_pool_matches_jax_and_stays_within_rtol(model):
    """A real prefill committed into both packages' int8 pools gives the
    same int8 blocks and scales byte for byte, and the gathered prefix and
    a suffix prefill over it stay within the JAX package's 0.05 contract
    (tests/test_speculate.py) of the exact rows."""
    jp, tp = model
    rng = np.random.default_rng(19)
    prompt = np.tile(rng.integers(1, JCFG.vocab_size, 11), 2)[None]
    empty_t = torch.zeros((TCFG.num_layers, 0) + KV_SHAPE[2:])
    empty_j = jnp.zeros((JCFG.num_layers, 0) + KV_SHAPE[2:], jnp.float32)
    with torch.inference_mode():
        ref_logits, ck, cv = _prefill_paged(tp, torch.from_numpy(prompt),
                                            TCFG, empty_t, empty_t)
    _, jck, jcv = j_prefill_paged(jp, jnp.asarray(prompt, jnp.int32), JCFG,
                                  empty_j, empty_j)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), **OP_TOL)
    both = _Both(num_blocks=32, int8=True)
    m = both.lookup(prompt[0], prompt.shape[1] - 1)
    # both pools quantize the port's fill, so their bytes must agree
    both.commit(prompt[0], (ck.numpy(), cv.numpy()), m)
    for got, want in both.pools():
        np.testing.assert_array_equal(got, want)
    m2 = both.lookup(prompt[0], prompt.shape[1] - 1)
    assert m2[1].tokens > 0
    gk, gv = both.gather(m2)
    ref_k = ck.numpy()[:, :m2[1].tokens]
    assert np.abs(gk - ref_k).max() / np.abs(ref_k).max() < 0.05
    with torch.inference_mode():
        q_logits, _, _ = _prefill_paged(
            tp, torch.from_numpy(prompt[:, m2[1].tokens:]), TCFG,
            torch.from_numpy(gk), torch.from_numpy(gv))
    ref = ref_logits[0, :TCFG.vocab_size]
    got = q_logits[0, :TCFG.vocab_size]
    assert float((got - ref).abs().max() / ref.abs().max()) < 0.05
    st = both.stats()
    assert st["int8"] and st["capacity_factor"] == 2


def test_int8_engine_serves_with_prefix_reuse(model):
    _, tp = model
    shared = [71, 72, 73, 74, 75, 76, 77, 78]
    eng = _engine(tp, kv_int8=True)
    base = _engine(tp, prefix_cache=False)
    try:
        first = eng.generate(shared + [80], 10)   # miss: no gather
        assert first == base.generate(shared + [80], 10)
        again = eng.stream(shared + [81], 10)
        assert len(list(again)) == 10 and again.cache_outcome == "hit"
        st = eng.kv_stats()
    finally:
        eng.stop()
        base.stop()
    assert st["int8"] is True and st["kv_int8"] is True
    assert st["hits"] + st["partial_hits"] >= 1
    assert st["num_blocks"] == 32 and st["pinned_blocks"] == 0


# ------------------------------------------------------- engine

def test_cached_engine_matches_uncached_and_jax(model):
    """The JAX package's cached-vs-uncached case: cached streams equal the
    uncached engine's, generate()'s and the JAX cached engine's; the
    first token's logprob agrees with the uncached one to the fp32 op
    tolerance."""
    jp, tp = model
    cached, uncached = _engine(tp), _engine(tp, prefix_cache=False)
    jeng = _jengine(jp)
    base = [1, 2, 3, 4, 5, 6, 7, 8]
    prompts = [base, base, base + [9, 10, 11], base[:6] + [7, 7], [5, 5, 5]]
    try:
        for p in prompts:
            s = cached.stream(p, 6)
            got = list(s)
            u = uncached.stream(p, 6)
            assert got == list(u) == jeng.generate(p, 6), p
            assert got == _reference(tp, p, 6), p
            np.testing.assert_allclose(s.scores, u.scores, **OP_TOL)
        st, jst = cached.kv_stats(), jeng.kv_stats()
        assert st["hits"] >= 1 and st["reused_tokens"] > 0
        assert uncached.kv_stats()["enabled"] is False
        assert uncached.kv_stats()["reused_tokens"] == 0
    finally:
        cached.stop()
        uncached.stop()
        jeng.stop()
    common = set(st) & set(jst) - {"engine_id", "prefill_programs"}
    assert {k: st[k] for k in common} == {k: jst[k] for k in common}
    assert st["prefill_programs"] == -1
    # every key the JAX engine reports, speculation, adoption and LoRA
    # among them
    assert {"admitted", "prefill_admitted", "prefill_calls",
            "spliced_tokens", "cancelled", "cancelled_by_reason",
            "max_prefills_admitted_per_tick", "kv_int8", "hit_rate",
            "token_reuse_rate", "pool_bytes", "adopted",
            "max_adoptions_per_tick", "max_adoptions_admitted_per_tick",
            "lora", "speculate_k", "spec_proposed", "spec_accepted",
            "spec_verify_ticks", "spec_emitted_tokens", "acceptance_rate",
            "tokens_per_verify"} <= common
    assert set(jst) - set(st) == set()


@pytest.mark.parametrize("suffix", [1, 2, 5, 9])
def test_suffix_prefill_logits_match_full_prefill(model, suffix):
    """A suffix prefilled on a gathered prefix against the same prompt
    prefilled whole, for Llama and GPT-2 (whose M = 2-5 rows differ in
    the last bits on the CPU): logits and the filled window within the
    fp32 op tolerance."""
    _, tp = model
    gp = tgpt2.gpt2_init(TGCFG, torch.Generator().manual_seed(4),
                         device="cpu")
    rng = np.random.default_rng(suffix)
    for cfg, params, heads in ((TCFG, tp, KV_SHAPE[2:]),
                               (TGCFG, gp, (TGCFG.num_heads,
                                            TGCFG.head_dim))):
        prompt = rng.integers(0, cfg.vocab_size, 12 + suffix)[None]
        kv = tkv.PagedKVCache(cfg, block_size=BS, num_blocks=16,
                              device="cpu")
        empty = torch.zeros((cfg.num_layers, 0) + heads)
        with torch.inference_mode():
            full, fk, _ = _prefill_paged(params, torch.from_numpy(prompt),
                                         cfg, empty, empty)
            head = prompt[:, :12]
            _, hk, hv = _prefill_paged(params, torch.from_numpy(head), cfg,
                                       empty, empty)
            kv.commit(head[0], hk, hv, kv.lookup(head[0], 11))
            m = kv.lookup(prompt[0], prompt.shape[1] - 1)
            assert m.tokens == 12
            pk, pv = kv.gather(m)
            part, sk, _ = _prefill_paged(
                params, torch.from_numpy(prompt[:, 12:]), cfg, pk, pv)
        torch.testing.assert_close(part, full, **OP_TOL)
        torch.testing.assert_close(sk, fk, **OP_TOL)


def test_weight_swap_invalidates_prefix_cache(model):
    _, tp = model
    params_b = tree_map(lambda x: x * 1.25, tp)
    eng = _engine(tp, params_version=1)
    fresh_b = _engine(params_b, prefix_cache=False)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    try:
        eng.generate(prompt, 4)                   # caches under A
        applied = eng.update_params(params_b, version=2)
        assert applied.wait(timeout=30.0)
        s = eng.stream(prompt, 4)
        assert list(s) == fresh_b.generate(prompt, 4)
        assert s.cache_outcome == "miss"
        st = eng.kv_stats()
        assert st["invalidations"] == 1
        assert eng.params_version == 2 and eng.swap_count == 1
    finally:
        eng.stop()
        fresh_b.stop()
    late = eng.update_params(tp, version=3)       # after stop(): applied
    assert late.wait(timeout=5.0) and eng.params_version == 3


def _hold_loop(eng):
    """Park the decode loop inside its next admission until the returned
    `release()` is called: work queued meanwhile is seen at one tick
    boundary."""
    gate, entered = threading.Event(), threading.Event()
    admit = eng._admit

    def held():
        entered.set()
        gate.wait(30.0)
        admit()

    eng._admit = held
    assert entered.wait(30.0)

    def release():
        eng._admit = admit
        gate.set()
    return release


def test_swaps_between_two_ticks_coalesce(model):
    _, tp = model
    p2 = tree_map(lambda x: x * 1.5, tp)
    p3 = tree_map(lambda x: x * 0.5, tp)
    eng = _engine(tp)
    fresh = _engine(p3, prefix_cache=False)
    try:
        release = _hold_loop(eng)
        e2 = eng.update_params(p2, version=2)
        e3 = eng.update_params(p3, version=3)
        assert not e2.is_set()
        release()
        assert e2.wait(30.0) and e3.wait(30.0)
        assert eng.swap_count == 1 and eng.params_version == 3
        assert eng.kv_stats()["invalidations"] == 1
        assert eng.generate([3, 1, 4], 5) == fresh.generate([3, 1, 4], 5)
    finally:
        eng.stop()
        fresh.stop()


def test_stop_fires_a_swap_the_loop_never_applied(model):
    _, tp = model
    eng = _engine(tp)
    release = _hold_loop(eng)
    ev = eng.update_params(tp, version=7)
    eng._stopped.set()
    release()
    eng._thread.join(timeout=30.0)
    assert not eng._thread.is_alive() and not ev.is_set()
    eng.stop()
    assert ev.is_set() and eng.params_version == 7


def test_prefix_reuse_drops_prefill_work(model):
    jp, tp = model
    eng, jeng = _engine(tp), _jengine(jp)
    shared = [11, 12, 13, 14, 15, 16, 17, 18]         # 2 aligned blocks
    prompts = [shared + [30 + i] for i in range(4)]
    try:
        for p in prompts:
            assert eng.generate(p, 3) == _reference(tp, p, 3) == \
                jeng.generate(p, 3)
        st, jst = eng.kv_stats(), jeng.kv_stats()
    finally:
        eng.stop()
        jeng.stop()
    assert st["misses"] == 1 and st["hits"] == 3
    assert st["prefilled_tokens"] == 9 + 3 * 1
    assert st["reused_tokens"] == 3 * 8
    assert st["spliced_tokens"] == 4 * 9
    assert st["prefill_calls"] == st["admitted"] == 4
    for key in ("misses", "hits", "prefilled_tokens", "reused_tokens",
                "spliced_tokens", "inserted_blocks", "cached_blocks"):
        assert st[key] == jst[key], key


def test_pool_exhaustion_falls_back_to_full_prefill(model):
    _, tp = model
    eng = _engine(tp, kv_pool_blocks=2)
    try:
        for i in range(5):
            p = [60 + 10 * i + j for j in range(8)]   # all distinct
            assert eng.generate(p, 3) == _reference(tp, p, 3), p
        st = eng.kv_stats()
    finally:
        eng.stop()
    assert st["pinned_blocks"] == 0 and st["num_blocks"] == 2
    assert st["evictions"] > 0


def test_admission_cap_bounds_prefill_bursts(model):
    _, tp = model
    prompts = [[i + 1, i + 2] for i in range(6)]
    for cap in (1, 3):
        eng = _engine(tp, max_prefills_per_tick=cap)
        try:
            assert eng.max_prefills_per_tick == cap
            release = _hold_loop(eng)
            with cf.ThreadPoolExecutor(6) as pool:
                futs = [pool.submit(eng.generate, p, 4) for p in prompts]
                deadline = time.monotonic() + 30.0
                while eng._pending.qsize() < 6:
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
                release()
                got = [f.result(timeout=120) for f in futs]
            for p, g in zip(prompts, got):
                assert g == _reference(tp, p, 4), p
            assert eng.max_prefills_admitted_per_tick == cap
            assert eng.kv_stats()["prefill_admitted"] == 6
        finally:
            eng.stop()


def _keep_drained(cache):
    """Keep every event the engine's telemetry push drains (with no
    cluster it only drains, as the JAX engine's does); the cache's
    drain_events() then returns them all."""
    drained = []
    drain = cache.drain_events
    cache.drain_events = lambda: drained.extend(drain()) or drained


def test_stream_exposes_cache_outcome(model):
    _, tp = model
    eng = _engine(tp)
    _keep_drained(eng.kv_cache)
    try:
        p = [41, 42, 43, 44, 45, 46, 47, 48]
        s1 = eng.stream(p, 3)
        assert list(s1) and s1.cache_outcome == "miss"
        assert s1.reused_tokens == 0
        s2 = eng.stream(p, 3)
        assert list(s2) and s2.cache_outcome == "hit"
        # the cap is plen - 1: one block is reusable, the rest prefills
        assert s2.reused_tokens == 4
        s3 = eng.stream(p[:6] + [1, 2, 3, 4, 5, 6], 3)
        assert list(s3) and s3.cache_outcome == "partial"
        assert s3.reused_tokens == 4
        events = eng.kv_cache.drain_events()
        assert [e["outcome"] for e in events
                if e["kind"] == "prefix_hit"] == ["hit", "partial"]
    finally:
        eng.stop()
    uncached = _engine(tp, prefix_cache=False)
    try:
        s = uncached.stream([1, 2, 3], 2)
        assert list(s) and s.cache_outcome is None
    finally:
        uncached.stop()


def test_cancel_slot_frees_and_readmits(model):
    _, tp = model
    eng = _engine(tp, max_batch=1)
    try:
        stream = eng.stream([5, 6, 7, 8, 9], 80)
        queued = eng.stream([1, 2, 3], 5)
        it = iter(stream)
        next(it)
        assert eng.cancel_slot(queued, reason="deadline") is True
        assert eng.cancel_slot(stream) is True
        assert eng.cancel_slot(stream) is False
        assert len(list(it)) < 79             # ends at a tick boundary
        assert list(queued) == []             # dropped at admission
        deadline = time.monotonic() + 10.0
        while eng.cancelled < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.cancelled == 2
        assert eng.cancelled_by_reason == {"deadline": 1, "unspecified": 1}
        # the freed slot admits again
        assert eng.generate([3, 1, 4], 6) == _reference(tp, [3, 1, 4], 6)
        st = eng.kv_stats()
        assert st["pinned_blocks"] == 0 and st["cancelled"] == 2
        assert eng.free_slots == 1
    finally:
        eng.stop()


def test_engine_streams_match_jax_engine_on_shared_prefixes(model):
    """Concurrent shared-prefix traffic, cache on in both packages (Llama
    tiny), then the same on GPT-2 tiny: the port's streams equal the JAX
    engine's and generate()'s."""
    jp, tp = model
    rng = np.random.default_rng(11)
    system = rng.integers(0, JCFG.vocab_size, 10).tolist()
    prompts = [system + rng.integers(0, JCFG.vocab_size, n).tolist()
               for n in (1, 3, 6, 2)]
    prompts.append(prompts[1] + [7, 7])
    jgp = jgpt2.gpt2_init(JGCFG, jax.random.PRNGKey(3))
    tgp = from_jax_params(jax.tree.map(np.asarray, jgp), device="cpu")
    for cfg, jcfg, tparams, jparams in ((TCFG, JCFG, tp, jp),
                                        (TGCFG, JGCFG, tgp, jgp)):
        eng = ContinuousBatchingEngine(tparams, cfg, max_batch=2,
                                       kv_block_size=BS, kv_pool_blocks=32)
        jeng = JEngine(jparams, jcfg, max_batch=2, kv_block_size=BS,
                       kv_pool_blocks=32, speculate_k=0)
        try:
            want = [jeng.generate(p, 5) for p in prompts]
            with cf.ThreadPoolExecutor(len(prompts)) as pool:
                got = list(pool.map(lambda p: eng.generate(p, 5), prompts))
            st = eng.kv_stats()
        finally:
            eng.stop()
            jeng.stop()
        assert got == want
        for p, g in zip(prompts, got):
            assert g == _reference(tparams, p, 5, cfg)
        assert st["hits"] + st["partial_hits"] >= 3
        assert st["pinned_blocks"] == 0


# ------------------------------------------------------- stream_generate

def test_stream_generate_matches_jax_and_generate(model):
    jp, tp = model
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, JCFG.vocab_size, (2, 8))
    want = np.stack([np.asarray(t) for t in jstream_generate(
        jp, JCFG, jnp.asarray(prompt, jnp.int32), max_new_tokens=6)], 1)
    got = list(stream_generate(tp, TCFG, prompt, max_new_tokens=6))
    assert all(t.shape == (2,) and t.dtype == torch.int64 for t in got)
    got = torch.stack(got, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, generate(tp, TCFG, prompt, max_new_tokens=6))


def test_stream_generate_eos_and_sampling(model):
    jp, tp = model
    prompt = np.asarray([[5, 6], [9, 9]])
    greedy = generate(tp, TCFG, prompt, max_new_tokens=8)
    eos = int(greedy[0, 2])
    got = torch.stack(list(stream_generate(tp, TCFG, prompt,
                                           max_new_tokens=8,
                                           eos_token=eos)), 1)
    want = np.stack([np.asarray(t) for t in jstream_generate(
        jp, JCFG, jnp.asarray(prompt, jnp.int32), max_new_tokens=8,
        eos_token=eos)], 1)
    np.testing.assert_array_equal(got.numpy(), want)
    full = generate(tp, TCFG, prompt, max_new_tokens=8, eos_token=eos)
    assert torch.equal(got, full[:, :got.shape[1]])
    # every row done: the stream ends early, all EOS from then on
    one = list(stream_generate(tp, TCFG, prompt[:1], max_new_tokens=8,
                               eos_token=eos))
    assert len(one) == int((greedy[0] == eos).nonzero()[0]) + 1

    def sampled(fn):
        return fn(tp, TCFG, prompt, max_new_tokens=6, temperature=0.8,
                  top_k=5, generator=torch.Generator().manual_seed(1))

    assert torch.equal(torch.stack(list(sampled(stream_generate)), 1),
                       sampled(generate))
    with pytest.raises(ValueError, match="max_seq_len"):
        next(stream_generate(tp, TCFG, np.zeros((1, 120), np.int64),
                             max_new_tokens=20))


def test_stats_readers_race_the_loop(model):
    """kv_stats() from many threads while the loop admits shared-prefix
    traffic, with the interpreter switching threads as often as it can:
    every snapshot is a consistent pool (no block both free and cached,
    pins within the allocated blocks), and the streams stay right."""
    import sys

    _, tp = model
    eng = _engine(tp, kv_pool_blocks=12)
    prompts = [[9, 8, 7, 6, 5, 4, 3, 2] + [i, i + 1] for i in range(8)]
    bad, stop = [], threading.Event()

    def read():
        while not stop.is_set():
            st = eng.kv_stats()
            free, n = st["free_blocks"], st["num_blocks"]
            if not (0 <= free <= n and st["cached_blocks"] + free <= n
                    and st["pinned_blocks"] <= n - free):
                bad.append(st)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=read) for _ in range(8)]
    try:
        for th in readers:
            th.start()
        with cf.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda p: eng.generate(p, 3, timeout_s=60),
                                prompts))
    finally:
        stop.set()
        for th in readers:
            th.join(timeout=30)
        sys.setswitchinterval(interval)
        eng.stop()
    assert not any(th.is_alive() for th in readers)
    assert not bad, bad[:3]
    for p, g in zip(prompts, got):
        assert g == _reference(tp, p, 3), p
    st = eng.kv_stats()
    assert st["pinned_blocks"] == 0 and st["lookups"] == len(prompts)


# ------------------------------------------- the surfaces, in a cluster
# tests/test_kvcache.py test_all_surfaces_report_consistent_numbers's state,
# Prometheus, timeline, CLI and dashboard legs: a check of
# `_private/telemetry_checks.py` in a driver process of its own.

SURFACE_CHECKS = {"kvcache_all_surfaces_report_consistent_numbers": {
    "num_cpus": 4, "_system_config": {"log_to_driver": 0}}}


@pytest.fixture(scope="module")
def surface_outcomes():
    from ray_tpu_torch._private import isolated

    return isolated.run_checks(SURFACE_CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*SURFACE_CHECKS, "__session_ended__"])
def test_kvcache_surfaces_in_a_cluster(surface_outcomes, name):
    ok, text = surface_outcomes[name]
    assert ok, text
