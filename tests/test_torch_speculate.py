"""Speculative decoding in the PyTorch port against the JAX package's, on
the CPU: the verify form of `llama_decode` / `gpt2_decode` at the end of
the cache window, `PagedKVCache.propose`, and the speculating engine's
streams and counters (Llama tiny and GPT-2 tiny at fp32, JAX parameters
carried over by `from_jax_params`).

The verify form at the window's end: JAX clamps an out-of-range gather
(the RoPE and learned-position tables) and drops an out-of-range scatter
(the cache writes), so a slot whose positions run past max_seq_len still
gets logits on every column and leaves the cache rows below the window's
end as they were. The speculating engine meets that case whenever an
idle slot's last request ran to the end of the window. Tolerances: the
whole model's logits and caches within atol/rtol 1e-4 (the frameworks sum
in different orders); streams and counters equal.

The engine's telemetry push drains its spec events with no cluster, as
JAX's does; a case that reads them keeps every drained event. In a
cluster (`telemetry_checks.speculate_all_surfaces_report_consistent_
numbers`), speculation_stats(), the spec events, the ``ray_tpu_spec_*``
Prometheus families and the timeline's speculation lane carry the
engine's own numbers."""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import kvcache as jkv
from ray_tpu.models import llama as jllama
from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import kvcache as tkv
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.tree import tree_map

JCFG = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
JGCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
TGCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype=torch.float32)
S = TCFG.max_seq_len
BS = 4
TOL = dict(atol=1e-4, rtol=1e-4)

FAMILIES = {
    "llama": (JCFG, TCFG, jllama.llama_init, jllama.init_kv_cache,
              tllama.init_kv_cache, jllama.llama_decode,
              tllama.llama_decode),
    "gpt2": (JGCFG, TGCFG, jgpt2.gpt2_init, jgpt2.gpt2_init_kv_cache,
             tgpt2.gpt2_init_kv_cache, jgpt2.gpt2_decode,
             tgpt2.gpt2_decode),
}


@pytest.fixture(scope="module")
def model():
    jp = jllama.llama_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def gpt2_model():
    jp = jgpt2.gpt2_init(JGCFG, jax.random.PRNGKey(3))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _engine(params, cfg=TCFG, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_pool_blocks", 32)
    return ContinuousBatchingEngine(params, cfg, **kw)


def _jengine(params, cfg=JCFG, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_pool_blocks", 32)
    kw.setdefault("speculate_k", 0)
    return JEngine(params, cfg, **kw)


def _reference(tp, prompt, n, cfg=TCFG):
    return generate(tp, cfg, [prompt], max_new_tokens=n)[0].tolist()


def _prompts(seed=3, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TCFG.vocab_size, ln).tolist()
            for ln in rng.integers(6, 20, n)]


def _concurrently(eng, prompts, n, **kw):
    with cf.ThreadPoolExecutor(len(prompts)) as pool:
        futs = [pool.submit(eng.generate, p, n, **kw) for p in prompts]
        return [f.result(timeout=120) for f in futs]


SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_verify_ticks",
             "spec_emitted_tokens")


# ------------------------------------------- the verify form at the end

@pytest.mark.parametrize("pos, width", [
    ([S - 2, 0], 4),        # slot 0's last two columns pass the window
    ([S - 1, S + 2], 5),    # an idle slot past the window
    ([S, S - 1], 0),        # the one-token form, one slot past the end
])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_verify_form_at_window_end_matches_jax(family, pos, width):
    """Logits on every column, the out-of-range ones included, and the
    whole cache after the step, against the JAX function on the same
    cache contents."""
    jcfg, tcfg, init, jinit_cache, tinit_cache, jdec, tdec = \
        FAMILIES[family]
    jp = init(jcfg, jax.random.PRNGKey(1))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    jcache = jinit_cache(jcfg, 2)
    tcache = tinit_cache(tcfg, 2, device="cpu")
    for jb, tb in zip(jcache, tcache):
        for name in ("k", "v"):
            fill = rng.standard_normal(tb[name].shape).astype(np.float32)
            jb[name] = jnp.asarray(fill)
            tb[name].copy_(torch.from_numpy(fill))
    shape = (2, width) if width else (2,)
    tokens = rng.integers(0, jcfg.vocab_size, shape)
    pos = np.asarray(pos)
    jl, jcache = jdec(jp, jnp.asarray(tokens, jnp.int32), jcfg, jcache,
                      jnp.asarray(pos, jnp.int32))
    with torch.inference_mode():
        tl, tcache = tdec(tp, torch.from_numpy(tokens), tcfg, tcache,
                          torch.from_numpy(pos))
    assert tl.shape == tuple(np.shape(jl))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for jb, tb in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(tb[name].numpy(),
                                       np.asarray(jb[name]), **TOL)


def test_verify_form_refuses_more_tokens_than_the_window(model):
    _, tp = model
    cache = tllama.init_kv_cache(TCFG, 1, max_len=4, device="cpu")
    with pytest.raises(ValueError, match="window"):
        tllama.llama_decode(tp, torch.zeros((1, 5), dtype=torch.long), TCFG,
                            cache, torch.zeros(1, dtype=torch.long))


# ------------------------------------------------------- propose

def _fill(seed):
    rng = np.random.default_rng(seed)
    shape = (JCFG.num_layers, S, JCFG.num_kv_heads, JCFG.head_dim)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("num_blocks", [32, 5])
def test_propose_matches_jax(num_blocks):
    """Both packages' pools committed in lockstep (shared chains, a
    partial tail, a namespace, and at 5 blocks evictions that drop
    forward-index entries): `propose` gives the same drafts for every
    context, and `stats()` agree."""
    j = jkv.PagedKVCache(JCFG, block_size=BS, num_blocks=num_blocks)
    t = tkv.PagedKVCache(TCFG, block_size=BS, num_blocks=num_blocks,
                         device="cpu")
    rng = np.random.default_rng(2)
    base = rng.integers(1, 500, 8).tolist()
    prompts = [(base + rng.integers(1, 500, n).tolist(), ns)
               for n, ns in ((6, None), (9, None), (3, "t@v1"),
                             (12, None), (5, None))]
    for i, (p, ns) in enumerate(prompts):
        ck, cv = _fill(i)
        toks = np.asarray(p)
        mj = j.lookup(toks, len(p) - 1, namespace=ns)
        mt = t.lookup(toks, len(p) - 1, namespace=ns)
        tj = j.commit(toks, jnp.asarray(ck), jnp.asarray(cv), mj,
                      namespace=ns)
        tt = t.commit(toks, torch.from_numpy(ck), torch.from_numpy(cv), mt,
                      namespace=ns)
        assert tt == tj
        j.release(tj)
        t.release(tt)
    contexts = [(p[:n], ns) for p, ns in prompts for n in
                (1, 3, 4, 7, 8, 9, 11, len(p) - 1)]
    contexts += [(base, "t@v1"), (base, "nobody"), ([499] * 9, None)]
    drafted = 0
    for ctx, ns in contexts:
        for k in (1, 4, 9):
            got = t.propose(ctx, k, namespace=ns)
            assert got == j.propose(ctx, k, namespace=ns), (ctx, k, ns)
            drafted += bool(got)
    assert drafted > 10
    assert t.stats() == j.stats()
    t.invalidate()
    assert t.propose(base, 4) == [] and not t._children


# ------------------------------------------------------- engine

def _scripted_source(chain, corrupt_at=None):
    """Drafts from the true greedy chain (full acceptance), one position
    corrupted (partial)."""
    def src(ctx, k):
        if chain[:len(ctx)] != ctx:
            return []
        out = list(chain[len(ctx):len(ctx) + k])
        if corrupt_at is not None and len(out) > corrupt_at:
            out[corrupt_at] = (out[corrupt_at] + 1) % TCFG.vocab_size
        return out
    return src


@pytest.mark.parametrize("mode", ["full", "partial", "zero"])
def test_acceptance_spectrum_matches_jax(model, mode):
    """Speculated streams equal generate() and the JAX speculating
    engine's whether the drafts are right, half wrong or garbage, with the
    same proposed, accepted and verify-step counts."""
    jp, tp = model
    prompt = _prompts(seed=7, n=1)[0]
    ref = _reference(tp, prompt, 24)
    chain = prompt + ref
    src = {"full": _scripted_source(chain),
           "partial": _scripted_source(chain, corrupt_at=2),
           "zero": lambda ctx, k: [0] * k}[mode]
    eng = _engine(tp, speculate_k=4, draft_source=src)
    jeng = _jengine(jp, speculate_k=4, draft_source=src)
    try:
        got = eng.generate(prompt, 24)
        want = jeng.generate(prompt, 24)
        st, jst = eng.speculation_stats(), jeng.speculation_stats()
    finally:
        eng.stop()
        jeng.stop()
    assert got == want == ref
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["spec_proposed"] > 0
    if mode == "full":
        assert st["acceptance_rate"] == 1.0 and st["tokens_per_verify"] > 4
    elif mode == "zero":
        assert st["spec_accepted"] == 0
    else:
        assert 0.0 < st["acceptance_rate"] < 1.0


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_default_proposer_matches_jax(model, gpt2_model, family):
    """The built-in proposer (prefix-cache chains, output memory, self
    n-grams) over repeated prompts: streams equal the unspeculated
    engine's and the JAX speculating engine's, with equal counters, and
    the repeats draft from the output memory at high acceptance."""
    jp, tp = model if family == "llama" else gpt2_model
    cfg, jcfg = (TCFG, JCFG) if family == "llama" else (TGCFG, JGCFG)
    prompts = _prompts(seed=11, n=3)
    jobs = prompts + prompts
    base = _engine(tp, cfg)
    eng = _engine(tp, cfg, speculate_k=4)
    jeng = _jengine(jp, jcfg, speculate_k=4)
    # the engine's telemetry push drains its events (with no cluster, as
    # JAX's does): keep every drained event
    events = []
    drain = eng._drain_spec_events
    eng._drain_spec_events = lambda: events.extend(drain()) or []
    try:
        want = [base.generate(p, 20) for p in jobs]
        got = [eng.generate(p, 20) for p in jobs]
        jgot = [jeng.generate(p, 20) for p in jobs]
        st, jst = eng.kv_stats(), jeng.kv_stats()
        eng._drain_spec_events()
    finally:
        base.stop()
        eng.stop()
        jeng.stop()
    assert got == want == jgot
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["spec_accepted"] > 0 and st["acceptance_rate"] > 0.4
    assert sum(e["accepted"] for e in events) == st["spec_accepted"]
    assert sum(e["proposed"] for e in events) == st["spec_proposed"]
    assert st["pinned_blocks"] == 0


def test_concurrent_mixed_batch_equals_generate(model):
    """Slots at different depths, some drafting and some not, in one
    verify step: concurrent speculated streams equal generate()."""
    _, tp = model
    prompts = _prompts(seed=13, n=4)
    eng = _engine(tp, speculate_k=4)
    try:
        got = _concurrently(eng, prompts, 16)
        assert eng.spec_verify_ticks > 0
    finally:
        eng.stop()
    assert got == [_reference(tp, p, 16) for p in prompts]


def test_rollback_leaves_pool_leak_free(model):
    """Rejected drafts roll back by refcount, never by copy: after
    speculated shared-prefix traffic no pin is left and every block is
    free or cached."""
    _, tp = model
    shared = [41, 42, 43, 44, 45, 46, 47, 48]
    eng = _engine(tp, speculate_k=4)
    try:
        for i in list(range(4)) + [0, 1]:
            assert eng.generate(shared + [60 + i], 12) == \
                _reference(tp, shared + [60 + i], 12)
        st = eng.kv_stats()
    finally:
        eng.stop()
    assert st["spec_verify_ticks"] > 0
    assert st["pinned_blocks"] == 0
    assert st["free_blocks"] + st["cached_blocks"] == st["num_blocks"]


def test_weight_swap_clears_the_output_memory(model):
    """A same-weights swap mid-stream leaves the stream unchanged and
    clears the output memory; after a swap to other weights the streams
    equal a fresh engine's on them, never a stale draft's."""
    _, tp = model
    params_b = tree_map(lambda x: x * 1.25, tp)
    prompt = _prompts(seed=17, n=1)[0]
    ref_a = _reference(tp, prompt, 24)
    eng = _engine(tp, speculate_k=4)
    fresh = _engine(params_b, prefix_cache=False)
    try:
        eng.generate(prompt, 24)  # fills the output memory
        assert len(eng._output_memory) == 1
        stream = eng.stream(prompt, 24)
        first = next(stream)
        applied = eng.update_params(tp, version=2)
        rest = list(stream)
        assert applied.wait(timeout=30.0)
        assert [first] + rest == ref_a
        assert len(eng._output_memory) <= 1  # cleared at the swap
        assert eng.update_params(params_b, version=3).wait(timeout=30.0)
        assert eng.generate(prompt, 16) == fresh.generate(prompt, 16)
    finally:
        eng.stop()
        fresh.stop()


def test_eos_stops_where_the_plain_engine_does(model):
    """An EOS inside an accepted draft ends the stream there."""
    _, tp = model
    prompt = _prompts(seed=19, n=1)[0]
    ref = _reference(tp, prompt, 20)
    eos = ref[7]
    chain = prompt + ref
    eng = _engine(tp, speculate_k=4, draft_source=_scripted_source(chain))
    base = _engine(tp)
    try:
        got = eng.generate(prompt, 20, eos_token=eos)
        assert got == base.generate(prompt, 20, eos_token=eos)
    finally:
        eng.stop()
        base.stop()
    assert got == ref[:ref.index(eos) + 1]


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


def _run_boundary(eng, jobs):
    release = _hold_loop(eng)
    streams = [eng.stream(p, n) for p, n in jobs]
    release()
    return [list(s) for s in streams]


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_boundary_request_then_verify_steps_with_a_stale_idle_slot(
        model, gpt2_model, family):
    """A request whose prompt + new tokens fill the window runs past it in
    its own verify steps' padded columns, then leaves its slot idle at
    position S-1 while another request keeps verifying (a draft every
    step, always rejected). Streams equal generate() and the JAX
    speculating engine's, with the same counters; the loop stays up."""
    jp, tp = model if family == "llama" else gpt2_model
    cfg, jcfg = (TCFG, JCFG) if family == "llama" else (TGCFG, JGCFG)
    rng = np.random.default_rng(23)
    jobs = [(rng.integers(1, cfg.vocab_size, S - 12).tolist(), 12),
            (_prompts(seed=29, n=1)[0], 30)]

    def src(ctx, k):
        return [0] * k

    eng = _engine(tp, cfg, max_batch=2, speculate_k=4, draft_source=src)
    jeng = _jengine(jp, jcfg, max_batch=2, speculate_k=4, draft_source=src)
    try:
        got = _run_boundary(eng, jobs)
        want = _run_boundary(jeng, jobs)
        assert sorted(eng._pos.tolist())[-1] == S - 1
        st, jst = eng.kv_stats(), jeng.kv_stats()
        assert eng._thread.is_alive()
        again = eng.generate(jobs[1][0], 10)
    finally:
        eng.stop()
        jeng.stop()
    assert got == want
    assert got == [_reference(tp, p, n, cfg) for p, n in jobs]
    assert again == got[1][:10]
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["spec_verify_ticks"] >= 29


def test_int8_pool_engine_speculates(model):
    """An int8-pool speculating engine: the miss stream (no gather)
    equals the fp engine's, and a hit drafts from the cache's chains."""
    _, tp = model
    shared = [71, 72, 73, 74, 75, 76, 77, 78]
    eng = _engine(tp, kv_int8=True, speculate_k=4)
    base = _engine(tp, prefix_cache=False)
    try:
        assert eng.generate(shared + [80], 10) == \
            base.generate(shared + [80], 10)
        assert len(eng.generate(shared + [81], 10)) == 10
        st = eng.kv_stats()
    finally:
        eng.stop()
        base.stop()
    assert st["int8"] and st["kv_int8"] and st["spec_verify_ticks"] > 0
    assert st["pinned_blocks"] == 0


def test_cancel_under_speculation_frees_the_slot(model):
    _, tp = model
    prompt = _prompts(seed=31, n=1)[0]
    eng = _engine(tp, max_batch=1, speculate_k=4)
    try:
        eng.generate(prompt, 40)  # the output memory drafts the repeat
        stream = eng.stream(prompt, 80)
        it = iter(stream)
        next(it)
        assert eng.cancel_slot(stream, reason="disconnect")
        assert len(list(it)) < 79
        assert eng.generate([3, 1, 4], 6) == _reference(tp, [3, 1, 4], 6)
        st = eng.kv_stats()
    finally:
        eng.stop()
    assert st["cancelled_by_reason"] == {"disconnect": 1}
    assert st["pinned_blocks"] == 0 and eng.free_slots == 1


# ------------------------------------------- the surfaces, in a cluster
# tests/test_speculate.py test_all_surfaces_report_consistent_numbers's state,
# Prometheus, timeline, CLI and dashboard legs: a check of
# `_private/telemetry_checks.py` in a driver process of its own.

SURFACE_CHECKS = {"speculate_all_surfaces_report_consistent_numbers": {
    "num_cpus": 4, "_system_config": {"log_to_driver": 0}}}


@pytest.fixture(scope="module")
def surface_outcomes():
    from ray_tpu_torch._private import isolated

    return isolated.run_checks(SURFACE_CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*SURFACE_CHECKS, "__session_ended__"])
def test_speculation_surfaces_in_a_cluster(surface_outcomes, name):
    ok, text = surface_outcomes[name]
    assert ok, text
