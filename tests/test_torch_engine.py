"""The PyTorch port's continuous-batching engine and generate() on the
CPU: greedy streams must equal the JAX package's engine and the port's
own generate(), token for token (GPT-2 tiny at fp32, JAX parameters
carried over with `from_jax_params`)."""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.models.generate import generate

JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype=torch.float32)
PROMPTS = [[7, 3, 9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [42]]
BUDGETS = [9, 6, 12]


@pytest.fixture(scope="module")
def params():
    jp = jgpt2.gpt2_init(JCFG, jax.random.PRNGKey(3))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _concurrently(engine, prompts, budgets, **kw):
    with cf.ThreadPoolExecutor(len(prompts)) as pool:
        futs = [pool.submit(engine.generate, p, n, **kw)
                for p, n in zip(prompts, budgets)]
        return [f.result(timeout=120) for f in futs]


def test_streams_match_jax_engine_and_generate(params):
    jp, tp = params
    jeng = JEngine(jp, JCFG, max_batch=2, prefix_cache=False,
                   speculate_k=0)
    teng = ContinuousBatchingEngine(tp, TCFG, max_batch=2)
    try:
        want = _concurrently(jeng, PROMPTS, BUDGETS)
        got = _concurrently(teng, PROMPTS, BUDGETS)
    finally:
        jeng.stop()
        teng.stop()
    assert not teng._thread.is_alive()
    for p, n, w, g in zip(PROMPTS, BUDGETS, want, got):
        assert len(g) == n
        assert g == w, p
        solo = generate(tp, TCFG, [p], max_new_tokens=n)
        assert g == solo[0].tolist(), p
    assert teng.free_slots == 2 and teng.active_slots == 0


def test_eos_and_stream_scores(params):
    _, tp = params
    ref = generate(tp, TCFG, [[3, 1, 4]], max_new_tokens=10)[0].tolist()
    # the first token that did not occur before it ends the stream there
    cut = next(i for i in range(1, 10) if ref[i] not in ref[:i])
    eng = ContinuousBatchingEngine(tp, TCFG, max_batch=2)
    try:
        assert eng.generate([3, 1, 4], 10, eos_token=ref[cut]) == \
            ref[:cut + 1]
        stream = eng.stream([3, 1, 4], 5)
        assert list(stream) == ref[:5]
        assert len(stream.scores) == 5
        assert all(s <= 0.0 for s in stream.scores)
    finally:
        eng.stop()


def test_generate_eos_and_sampling(params):
    _, tp = params
    greedy = generate(tp, TCFG, [[5, 6]], max_new_tokens=8)[0].tolist()
    eos = greedy[2]
    first = greedy.index(eos)
    out = generate(tp, TCFG, [[5, 6]], max_new_tokens=8,
                   eos_token=eos)[0].tolist()
    assert out[:first + 1] == greedy[:first + 1]
    assert all(t == eos for t in out[first:])

    def sample(seed):
        return generate(tp, TCFG, [[5, 6], [9, 9]], max_new_tokens=6,
                        temperature=0.8, top_k=5,
                        generator=torch.Generator().manual_seed(seed))

    a, b = sample(1), sample(1)
    assert torch.equal(a, b)
    assert a.shape == (2, 6) and int(a.max()) < TCFG.vocab_size


def test_engine_rejects_overlong_requests(params):
    _, tp = params
    eng = ContinuousBatchingEngine(tp, TCFG, max_batch=1)
    try:
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.submit([1] * 100, TCFG.max_seq_len)
    finally:
        eng.stop()


def test_bad_token_ids_refused_beside_good_requests(params):
    """A prompt with an id outside [0, vocab_size) is refused at submit;
    the requests beside it still stream their greedy tokens."""
    _, tp = params
    bad = [[1, TCFG.vocab_size], [-1, 2], [3, TCFG.padded_vocab + 7]]
    eng = ContinuousBatchingEngine(tp, TCFG, max_batch=2)
    try:
        with cf.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(eng.generate, p, n)
                    for p, n in zip(PROMPTS[:2], BUDGETS[:2])]
            for prompt in bad:
                with pytest.raises(ValueError, match="token ids"):
                    eng.submit(prompt, 4)
            got = [f.result(timeout=120) for f in futs]
        assert eng._thread.is_alive()
    finally:
        eng.stop()
    for p, n, g in zip(PROMPTS, BUDGETS, got):
        assert g == generate(tp, TCFG, [p], max_new_tokens=n)[0].tolist()


def test_loop_failure_reaches_every_caller(params, monkeypatch):
    """A decode loop that dies hands its exception to the live streams
    and refuses new requests, instead of leaving callers to time out."""
    from ray_tpu_torch.models import engine as engine_mod

    def boom(*args, **kwargs):
        raise ValueError("prefill exploded")

    _, tp = params
    monkeypatch.setattr(engine_mod, "_prefill", boom)
    monkeypatch.setattr("threading.excepthook", lambda args: None)
    eng = ContinuousBatchingEngine(tp, TCFG, max_batch=1)
    try:
        with pytest.raises(RuntimeError, match="decode loop failed"):
            eng.generate([1, 2, 3], 4, timeout_s=30)
        eng._thread.join(timeout=30)
        assert not eng._thread.is_alive()
        with pytest.raises(RuntimeError, match="decode loop failed"):
            eng.submit([1], 1)
    finally:
        eng.stop()
