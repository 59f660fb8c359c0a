"""Adoption of KV prefilled elsewhere (`ContinuousBatchingEngine.
adopt_prefill`) in the PyTorch port against the JAX package's, on the CPU
(Llama tiny and GPT-2 tiny at fp32, JAX parameters carried over by
`from_jax_params`): a prompt's KV rows and first token come from one
engine's `_prefill_with_cache`, and an engine with no prefix cache
splices them into a slot and decodes on. Streams equal generate() and the
JAX engine's on the same adoptions; the engine refuses a layout or dtype
it does not hold on the caller's thread and goes on serving."""
from __future__ import annotations

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
from ray_tpu.models.engine import _prefill_with_cache as j_prefill
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import kvcache as tkv
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import (ContinuousBatchingEngine,
                                         _prefill_with_cache)
from ray_tpu_torch.models.generate import generate

JCFG = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
JGCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
TGCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype=torch.float32)
SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_verify_ticks",
             "spec_emitted_tokens")


@pytest.fixture(scope="module")
def models():
    jl = jllama.llama_init(JCFG, jax.random.PRNGKey(0))
    jg = jgpt2.gpt2_init(JGCFG, jax.random.PRNGKey(3))

    def t(p):
        return from_jax_params(jax.tree.map(np.asarray, p), device="cpu")

    return {"llama": (jl, t(jl), JCFG, TCFG),
            "gpt2": (jg, t(jg), JGCFG, TGCFG)}


def _prompts(seed, n=4):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 500, 8).tolist()
    return [system + rng.integers(1, 500, m).tolist()
            for m in rng.integers(1, 12, n)]


def _reference(tp, cfg, prompt, n):
    return generate(tp, cfg, [prompt], max_new_tokens=n)[0].tolist()


def _port_prefills(tp, cfg, prompts):
    """Each prompt through a cached prefill on a pool of its own (the
    later prompts hit the shared system prompt): (ck, cv [L, plen, H,
    hd], first token, score, outcome)."""
    kv = tkv.PagedKVCache(cfg, block_size=4, num_blocks=64, device="cpu")
    probe = tllama.init_kv_cache if cfg is TCFG else \
        tgpt2.gpt2_init_kv_cache
    empty = probe(cfg, 1, max_len=1, device="cpu")[0]["k"][0, :0]
    empty = empty[None].expand(cfg.num_layers, *empty.shape)
    out = []
    with torch.inference_mode():
        for p in prompts:
            ck, cv, table, first, score, outcome, *_ = _prefill_with_cache(
                tp, cfg, kv, np.asarray([p]), empty)
            kv.release(table)
            out.append((ck[:, :len(p)].clone(), cv[:, :len(p)].clone(),
                        first, score, outcome))
    return out


def _jax_prefills(jp, cfg, prompts):
    kv = jkv.PagedKVCache(cfg, block_size=4, num_blocks=64)
    shape = (cfg.num_layers, 0, kv._pool_k.shape[3], kv._pool_k.shape[4])
    empty = jnp.zeros(shape, jnp.float32)
    out = []
    for p in prompts:
        ck, cv, table, first, score, *_ = j_prefill(
            jp, cfg, kv, np.asarray([p], np.int32), empty)
        kv.release(table)
        out.append((ck[:, :len(p)], cv[:, :len(p)], first, score))
    return out


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_adopted_streams_match_generate_and_jax(models, family):
    """Four adopted prompts (KV from the port's cached prefill, and from
    the JAX package's as numpy arrays) on a `prefix_cache=False` engine:
    streams equal generate() and the JAX engine's adoptions; no prefill
    runs; the counters say what was spliced."""
    jp, tp, jcfg, tcfg = models[family]
    prompts = _prompts(5)
    fills = _port_prefills(tp, tcfg, prompts)
    jfills = _jax_prefills(jp, jcfg, prompts)
    want = [_reference(tp, tcfg, p, 8) for p in prompts]
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=4,
                                   prefix_cache=False)
    jeng = JEngine(jp, jcfg, max_batch=4, prefix_cache=False, speculate_k=0)
    try:
        streams = [eng.adopt_prefill(len(p), f, ck, cv, 8, score=s,
                                     cache_outcome=o)
                   for p, (ck, cv, f, s, o) in zip(prompts, fills)]
        got = [list(s) for s in streams]
        from_jax = [list(eng.adopt_prefill(len(p), f, np.asarray(ck),
                                           np.asarray(cv), 8))
                    for p, (ck, cv, f, _) in zip(prompts, jfills)]
        jgot = [list(jeng.adopt_prefill(len(p), f, ck, cv, 8))
                for p, (ck, cv, f, _) in zip(prompts, jfills)]
        st = eng.kv_stats()
    finally:
        eng.stop()
        jeng.stop()
    assert got == from_jax == jgot == want
    assert [s.cache_outcome for s in streams] == [f[4] for f in fills]
    assert fills[0][4] == "miss"
    assert all(f[4] in ("hit", "partial") for f in fills[1:])
    np.testing.assert_allclose([s.scores[0] for s in streams],
                               [f[3] for f in fills])
    assert st["prefill_calls"] == 0 and st["prefill_admitted"] == 0
    assert st["adopted"] == st["admitted"] == 8
    assert st["spliced_tokens"] == 2 * sum(len(p) for p in prompts)
    assert st["max_adoptions_admitted_per_tick"] >= 1
    assert st["max_adoptions_per_tick"] == 4


def test_adopt_refuses_a_foreign_layout_and_goes_on_serving(models):
    jp, tp, jcfg, tcfg = models["llama"]
    prompt = _prompts(7, 1)[0]
    plen = len(prompt)
    ck, cv, first, score, _ = _port_prefills(tp, tcfg, [prompt])[0]
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=2,
                                   prefix_cache=False)
    try:
        bad = [
            (ck.double(), cv.double(), {}),                   # dtype
            (ck.to(torch.bfloat16), cv, {}),                  # one dtype
            (ck.numpy().astype(np.float16), cv.numpy(), {}),  # numpy dtype
            (ck[:, :-1], cv[:, :-1], {}),                     # rows
            (ck[:, :, :1], cv[:, :, :1], {}),                 # heads
            (ck, cv, {"prompt_len": plen + 1}),               # prompt_len
        ]
        for k, v, kw in bad:
            with pytest.raises(ValueError, match="layout"):
                eng.adopt_prefill(kw.get("prompt_len", plen), first, k, v, 4)
        with pytest.raises(ValueError, match="token ids"):
            eng.adopt_prefill(plen, tcfg.vocab_size, ck, cv, 4)
        with pytest.raises(ValueError, match="prompt tokens"):
            eng.adopt_prefill(plen, first, ck, cv, 4,
                              prompt_tokens=prompt[:-1])
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.adopt_prefill(plen, first, ck, cv, tcfg.max_seq_len)
        with pytest.raises(ValueError):
            eng.adopt_prefill(0, first, ck[:, :0], cv[:, :0], 4)
        assert eng._pending_adopt.empty()
        got = list(eng.adopt_prefill(plen, first, ck.numpy(), cv.numpy(), 6,
                                     score=score))
        assert got == _reference(tp, tcfg, prompt, 6)
        assert eng.generate(prompt, 6) == got
        st = eng.kv_stats()
    finally:
        eng.stop()
    assert st["adopted"] == 1 and st["prefill_admitted"] == 1


def _hold_loop(eng):
    """Park the decode loop inside its next admission until the returned
    `release()` is called."""
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


def test_adoptions_go_first_under_their_own_cap(models):
    """Three adoptions and two prefills queued at one tick boundary, cap
    2 adoptions a tick: two adoptions, then one prefill, are admitted
    first; every stream is right and the cancelled adoption never takes a
    slot."""
    _, tp, _, tcfg = models["llama"]
    prompts = _prompts(9, 5)
    fills = _port_prefills(tp, tcfg, prompts[:4])
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=4,
                                   max_adoptions_per_tick=2)
    try:
        release = _hold_loop(eng)
        adopted = [eng.adopt_prefill(len(p), f, ck, cv, 5)
                   for p, (ck, cv, f, _, _) in zip(prompts, fills)]
        assert eng.cancel_slot(adopted[3], reason="deadline")
        submitted = [eng.stream(p, 5) for p in prompts[3:]]
        release()
        got = [list(s) for s in adopted[:3] + submitted]
        assert list(adopted[3]) == []
        st = eng.kv_stats()
    finally:
        eng.stop()
    want = [_reference(tp, tcfg, p, 5) for p in prompts[:3] + prompts[3:]]
    assert got == want
    assert st["max_adoptions_admitted_per_tick"] == 2
    assert st["adopted"] == 3 and st["prefill_admitted"] == 2
    assert st["cancelled_by_reason"] == {"deadline": 1}


def test_a_failed_loop_ends_pending_adoptions(models):
    """When the loop fails, the live adoption and the one still queued
    both get the error, and later adoptions and submits raise."""
    _, tp, _, tcfg = models["llama"]
    prompts = _prompts(11, 2)
    fills = _port_prefills(tp, tcfg, prompts)
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=1,
                                   prefix_cache=False)
    try:
        release = _hold_loop(eng)
        streams = [eng.adopt_prefill(len(p), f, ck, cv, 5)
                   for p, (ck, cv, f, _, _) in zip(prompts, fills)]

        def boom(*_):
            raise RuntimeError("decode failed")

        eng._decode = boom
        release()
        for s in streams:
            with pytest.raises(RuntimeError, match="decode loop failed"):
                list(s)
        eng._thread.join(timeout=30)
        assert not eng._thread.is_alive()
        ck, cv, f, _, _ = fills[0]
        with pytest.raises(RuntimeError, match="decode loop failed"):
            eng.adopt_prefill(len(prompts[0]), f, ck, cv, 5)
        with pytest.raises(RuntimeError, match="decode loop failed"):
            eng.submit(prompts[0], 5)
    finally:
        eng.stop()


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_speculating_engine_drafts_from_adopted_prompts(models, family):
    """A speculating decode engine adopting with `prompt_tokens`: repeats
    draft from the output memory; streams equal generate() and the JAX
    speculating engine's on the same adoptions, with equal counters."""
    jp, tp, jcfg, tcfg = models[family]
    prompts = _prompts(13, 2)
    jfills = _jax_prefills(jp, jcfg, prompts)
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=2,
                                   prefix_cache=False, speculate_k=4)
    jeng = JEngine(jp, jcfg, max_batch=2, prefix_cache=False, speculate_k=4)
    try:
        got, jgot = [], []
        for _ in range(2):
            for p, (ck, cv, f, s) in zip(prompts, jfills):
                got.append(list(eng.adopt_prefill(
                    len(p), f, np.asarray(ck), np.asarray(cv), 12,
                    prompt_tokens=p)))
                jgot.append(list(jeng.adopt_prefill(
                    len(p), f, ck, cv, 12, prompt_tokens=p)))
        st, jst = eng.kv_stats(), jeng.kv_stats()
    finally:
        eng.stop()
        jeng.stop()
    assert got == jgot == [_reference(tp, tcfg, p, 12) for p in prompts] * 2
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["spec_accepted"] > 0 and st["adopted"] == 4
