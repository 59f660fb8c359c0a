"""Serving fault tolerance in the port (ray_tpu_torch/serve/disagg.py's
failover, resilience/chaos.py's serving monkey) against the JAX
package's, on the CPU: Llama tiny in fp32, KV blocks of 4 tokens, JAX
parameters carried over by `from_jax_params`.

Twins of tests/test_servefault.py: a decode replica dying mid-stream
(the stream equals an uninterrupted run's, and the JAX engine's), a
prefill death before the ack, the failover budget and the deadline
shedding with their causes, the kill_replica plan firing exactly once.
Port checks: a kill_replica fire in this (driver) process raises and
the request fails over; a decode ACTOR killed by its chaos plan
mid-stream fails over to a replica in the driver
(`serve_checks.port_servefault_actor_decode_kill_fails_over`, in a
driver process of its own).

test_chunk_fetcher_retries_with_backoff and
test_delay_chunk_fetch_stretches_pulls have their twin in
tests/test_torch_weights.py::test_chunk_fetch_retries_and_chaos_delay.
The tier self-healer (serve/autoscale.py's DisaggAutoscaler): a death
replaced 1-for-1 through the tier factory and the per-host breaker
tripping once (its threshold the `breaker_threshold` argument, where the
JAX test sets RAY_TPU_SERVE_BREAKER_THRESHOLD), the drain / death race
reaping the drain record, and a decode ACTOR killed mid-stream healed
through its factory while the stream completes (`serve_checks.
servefault_actor_decode_kill_mid_stream_heals_and_completes`, its
streams held against the JAX engine).

The CLI and dashboard legs of test_all_surfaces_report_one_set_of_
numbers (`servefault --json` and `/api/servefault` equal to the state
view, the tail holding failover and replace) are in that actor check.

Not twinned: test_generic_replica_drain_rejects_with_cause waits for
serve/replica.py.
"""
from __future__ import annotations

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import llama_init as jllama_init
from ray_tpu.resilience import chaos as jchaos
from ray_tpu_torch._private import isolated, serve_checks
from ray_tpu_torch._private.serve_checks import FlakyDecode
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.resilience import chaos as tchaos
from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                        PrefillServer)
from ray_tpu_torch.serve.handle import RequestShedError
from ray_tpu_torch.tree import tree_map

JCFG = dataclasses.replace(JLlamaConfig.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
BS = serve_checks.BS
CLUSTER = {"num_cpus": 4, "_system_config": serve_checks.SYSTEM_CONFIG}
CHECKS = {name: CLUSTER for name in (
    "port_servefault_actor_decode_kill_fails_over",
    "servefault_actor_decode_kill_mid_stream_heals_and_completes")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.fixture(scope="module")
def models():
    jp = jllama_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _reference(tp, prompt, n):
    eng = ContinuousBatchingEngine(tp, TCFG, max_batch=4, kv_block_size=BS,
                                   kv_pool_blocks=32)
    try:
        return eng.generate(prompt, n)
    finally:
        eng.stop()


def _jax_reference(jp, prompt, n):
    eng = JEngine(jp, JCFG, max_batch=4, kv_block_size=BS,
                  kv_pool_blocks=32)
    try:
        return [int(t) for t in eng.generate(prompt, n)]
    finally:
        eng.stop()


def _prefill(tp):
    return PrefillServer(tp, TCFG, kv_block_size=BS, kv_pool_blocks=32,
                         device="cpu")


class FlakyPrefill:
    """A PrefillServer whose first `fail_first` prefills die before
    returning a record."""

    def __init__(self, inner, fail_first=0):
        self._inner = inner
        self._fails_left = fail_first

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def prefill(self, *a, **k):
        if self._fails_left > 0:
            self._fails_left -= 1
            raise ConnectionError("prefill replica died before ack")
        return self._inner.prefill(*a, **k)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_servefault_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_actor_kill_stream_matches_jax(outcomes):
    """The stream that survived the decode actor's death equals the JAX
    engine's on the check's weights."""
    ok, text = outcomes["port_servefault_actor_decode_kill_fails_over"]
    assert ok, text
    _, params = serve_checks.tiny_llama()
    jp = jax.tree.map(jnp.asarray, tree_map(lambda p: p.numpy(), params))
    assert json.loads(text)["stream"] == _jax_reference(
        jp, [21, 22, 23, 24, 25, 26, 27, 28], 12)


def test_decode_death_mid_stream_replays_bit_identical(models):
    """A decode replica dying after 3 tokens: the request completes with
    the stream of an uninterrupted run (and of the JAX engine); the
    corpse leaves the set, the failover is counted, nothing is held, and
    the replay reused the cached prefix."""
    jp, tp = models
    p = [1, 2, 3, 4, 5, 6, 7, 8]
    want = _reference(tp, p, 8)
    assert want == _jax_reference(jp, p, 8)
    pf = _prefill(tp)
    d1 = DecodeServer(tp, TCFG, max_batch=4, device="cpu")
    d2 = DecodeServer(tp, TCFG, max_batch=4, device="cpu")
    flaky = FlakyDecode(d1, die_after=3)
    router = DisaggRouter(decode=[FlakyDecode(d2), flaky], prefill=[pf],
                          max_queue_depth=4, affinity_tokens=BS)
    try:
        got = router.generate(p, 8)
    finally:
        d1.stop()
        d2.stop()
    assert got == want
    st = router.stats()
    assert st["failovers"] == {"prefill": 0, "decode": 1}
    assert st["failover_requests"] == 1
    assert st["shed"] == 0 and st["sheds_by_cause"] == {}
    assert [r["rid"] for r in router.tier_replicas("decode")] \
        == [d2.server_id]
    sf = router.servefault_stats()
    assert sf["removed_dead"]["decode"] == 1
    assert sf["recent_failover_recovery_ms"]["n"] == 1
    assert pf.stats()["held_transfers"] == 0
    assert pf.stats()["published_transfers"] == 2
    assert pf.stats()["reused_tokens"] > 0


def test_prefill_death_before_ack_retries_no_chunk_leak(models):
    _, tp = models
    p = [11, 12, 13, 14, 15]
    want = _reference(tp, p, 6)
    pf_good = _prefill(tp)
    flaky = FlakyPrefill(pf_good, fail_first=0)
    pf_dead = FlakyPrefill(_prefill(tp), fail_first=10 ** 9)
    dec = DecodeServer(tp, TCFG, max_batch=4, device="cpu")
    router = DisaggRouter(decode=[dec], prefill=[pf_dead, flaky],
                          max_queue_depth=4, affinity_tokens=BS)
    try:
        assert router.generate(p, 6) == want
        st = router.stats()
        if st["failovers"]["prefill"]:
            assert [r["rid"] for r in router.tier_replicas("prefill")] \
                == [pf_good.server_id]
        assert router.generate(p, 6) == want
    finally:
        dec.stop()
    assert st["shed"] == 0
    assert pf_good.stats()["held_transfers"] == 0


def test_failover_budget_exhaustion_sheds_with_cause(models):
    _, tp = models
    pf = _prefill(tp)
    d1 = DecodeServer(tp, TCFG, max_batch=4, device="cpu")
    always_dead = FlakyDecode(d1, die_after=0)
    always_dead.dead = True
    router = DisaggRouter(decode=[always_dead], prefill=[pf],
                          max_queue_depth=4, affinity_tokens=BS,
                          failover_attempts=1, failover_wait_s=0.5)
    try:
        with pytest.raises(RequestShedError) as ei:
            router.generate([1, 2, 3], 4)
    finally:
        d1.stop()
    assert ei.value.cause == "failover"
    st = router.stats()
    assert st["sheds_by_cause"].get("failover") == 1 and st["shed"] == 1


def test_deadline_sheds_with_cause(models):
    _, tp = models
    eng = ContinuousBatchingEngine(tp, TCFG, max_batch=2, kv_block_size=BS,
                                   kv_pool_blocks=32)
    router = DisaggRouter(colocated=eng, max_queue_depth=2)
    try:
        router.generate([1, 2, 3], 2)
        with pytest.raises(RequestShedError) as ei:
            router.generate([1, 2, 3], 4, deadline_s=0.0)
        assert ei.value.cause == "deadline"
        with pytest.raises(RequestShedError) as ei:
            router.generate([1, 2, 3, 4], 8, deadline_s=0.3,
                            token_sleep_s=0.2)
        assert ei.value.cause == "deadline"
    finally:
        eng.stop()
    assert router.stats()["sheds_by_cause"]["deadline"] == 2


@pytest.mark.parametrize("mod", [tchaos, jchaos], ids=["port", "jax"])
def test_kill_replica_plan_parses_and_fires_exactly_once(mod):
    spec = json.dumps([
        {"action": "kill_replica", "role": "decode", "at": "token:5"},
        {"action": "kill_replica", "role": "prefill", "at": "request:2",
         "replica": 1},
        {"action": "delay_chunk_fetch", "ms": 250},
    ])
    plan = mod.ChaosPlan.from_spec(spec)
    assert plan.chunk_fetch_delay_s() == 0.25
    assert len(plan.serve_actions("decode", 0)) == 1
    assert plan.serve_actions("decode", 1) == []
    assert len(plan.serve_actions("prefill", 1)) == 1
    fired = []
    m = mod.ServeChaosMonkey(plan, "decode", 0,
                             exit_fn=lambda code: fired.append(code))
    m.on_tokens(3)
    assert fired == []
    m.on_tokens(3)
    assert fired == [137]
    m.on_tokens(10)
    assert fired == [137]
    fired2 = []
    m2 = mod.ServeChaosMonkey(plan, "prefill", 1,
                              exit_fn=lambda code: fired2.append(code))
    m2.on_request()
    assert fired2 == []
    m2.on_request()
    assert fired2 == [137]
    with pytest.raises(ValueError):
        mod.ChaosPlan.from_spec(
            '[{"action": "kill_replica", "role": "decode"}]')
    with pytest.raises(ValueError):
        mod.ChaosPlan.from_spec(
            '[{"action": "kill_replica", "role": "gpu", "at": "token:1"}]')
    assert mod.serve_monkey_from_spec(
        '[{"action": "delay_chunk_fetch", "ms": 1}]', "decode") is None


def test_kill_replica_in_a_driver_raises_and_fails_over(models):
    """The default fire in this process (no cluster: a driver) raises
    ChaosError and never exits: the plan as a list, an in-process decode
    replica's pull raises, and the router fails the request over to the
    other replica with the uninterrupted run's stream."""
    _, tp = models
    plan = [{"action": "kill_replica", "role": "decode", "at": "token:3"}]
    monkey = tchaos.serve_monkey_from_spec(plan, "decode")
    monkey.on_tokens(2)
    with pytest.raises(tchaos.ChaosError):
        monkey.on_tokens(1)
    monkey.on_tokens(5)  # fired once: the latch holds
    p = [31, 32, 33, 34, 35, 36]
    want = _reference(tp, p, 10)
    pf = _prefill(tp)
    local = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    chaotic = DecodeServer(tp, TCFG, max_batch=2, chaos=plan, device="cpu")
    router = DisaggRouter(decode=[local, chaotic], prefill=[pf],
                          max_queue_depth=2, affinity_tokens=BS,
                          stream_chunk_tokens=2)
    try:
        assert router.generate(p, 10) == want
    finally:
        local.stop()
        chaotic.stop()
    st = router.stats()
    # a fire in a driver is a request failure, not a death: one failover
    # attempt, and the replica stays in the set
    assert st["failovers"] == {"prefill": 0, "decode": 1}
    assert len(router.tier_replicas("decode")) == 2
    assert pf.stats()["reused_tokens"] > 0


def test_batch_stream_preempted_by_interactive_resumes_bit_identical(models):
    """One decode slot, queue depth 0: an interactive arrival preempts
    the running batch-class stream (its slot cancelled) and rides its
    slot; the batch stream resumes by the replay and completes with the
    uninterrupted run's tokens."""
    import threading

    _, tp = models
    p, q = [41, 42, 43, 44, 45], [51, 52, 53]
    want_p, want_q = _reference(tp, p, 60), _reference(tp, q, 6)
    eng = ContinuousBatchingEngine(tp, TCFG, max_batch=1, kv_block_size=BS,
                                   kv_pool_blocks=32)
    router = DisaggRouter(colocated=eng, max_queue_depth=0)
    seen, out = [], {}
    started = threading.Event()

    def batch():
        out["p"] = router.generate(
            p, 60, priority="batch", token_sleep_s=0.01,
            on_tokens=lambda toks: (seen.extend(toks),
                                    len(seen) >= 5 and started.set()))

    th = threading.Thread(target=batch)
    th.start()
    try:
        assert started.wait(60.0)
        assert router.generate(q, 6, priority="interactive") == want_q
        th.join(120.0)
        assert not th.is_alive()
    finally:
        eng.stop()
    assert out["p"] == want_p
    st = router.stats()
    assert st["preemptions"] == 1 and st["preempted_requests"] == 1
    assert st["shed"] == 0 and st["completed"] == 2
    assert eng.cancelled_by_reason.get("preempt") == 1


def test_actor_heal_streams_match_jax(outcomes):
    """The healed request's stream and the replacement's equal the JAX
    engine's on the check's weights."""
    name = "servefault_actor_decode_kill_mid_stream_heals_and_completes"
    ok, text = outcomes[name]
    assert ok, text
    _, params = serve_checks.tiny_llama()
    jp = jax.tree.map(jnp.asarray, tree_map(lambda p: p.numpy(), params))
    want = _jax_reference(jp, [21, 22, 23, 24, 25, 26, 27, 28], 10)
    assert json.loads(text)["streams"] == [want, want]


# ------------------------------------------------------ tier self-healing

def _mk_scaler(router, factory, threshold=3.0):
    from ray_tpu_torch.serve.autoscale import DisaggAutoscaler, TierSpec

    hold = dict(min_replicas=1, max_replicas=4, up_delay_s=3600.0,
                down_delay_s=3600.0)
    return DisaggAutoscaler(
        router, prefill=TierSpec(factory["prefill"], **hold),
        decode=TierSpec(factory["decode"], **hold),
        interval_s=3600.0, drain_grace_s=1.0,
        breaker_threshold=threshold)


def test_self_heal_replaces_and_breaker_trips(models):
    """A death: the corpse leaves the router and a 1-for-1 replacement
    comes from the tier factory, outside hysteresis. Repeated deaths on
    one host trip the breaker (counted once per OPEN edge) and stop the
    replacements for that host; a death on another host still heals."""
    _, tp = models
    made = []

    def decode_factory():
        d = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
        made.append(d)
        return d

    router = DisaggRouter(decode=[decode_factory()], prefill=[_prefill(tp)],
                          max_queue_depth=2, affinity_tokens=BS)
    # between 1 and 2: the second death trips although the first one's
    # score decayed a little meanwhile
    scaler = _mk_scaler(router, {"prefill": lambda: _prefill(tp),
                                 "decode": decode_factory}, threshold=1.5)
    try:
        rep = router.tier_replicas("decode")[0]
        scaler._handle_replica_death(
            "decode", {"rid": rep["rid"], "machine": "hostA"})
        st = scaler.status()
        assert st["deaths"]["decode"] == 1
        assert st["replacements"]["decode"] == 1
        assert st["breaker_trips"] == 0
        assert len(router.tier_replicas("decode")) == 1
        rep = router.tier_replicas("decode")[0]
        scaler._handle_replica_death(
            "decode", {"rid": rep["rid"], "machine": "hostA"})
        st = scaler.status()
        assert st["deaths"]["decode"] == 2
        assert st["replacements"]["decode"] == 1
        assert st["replacements_blocked"] == 1
        assert st["breaker_trips"] == 1
        assert "hostA" in st["breaker_open"]
        assert "breaker open" in st["last_reason"]["decode"]
        scaler._replace("decode", "seed")
        rep = router.tier_replicas("decode")[-1]
        scaler._handle_replica_death(
            "decode", {"rid": rep["rid"], "machine": "hostB"})
        st = scaler.status()
        assert st["replacements"]["decode"] == 3
        assert st["breaker_trips"] == 1
        sf = scaler.servefault_stats()
        assert sf["deaths"] == st["deaths"]
        assert sf["replacements"] == st["replacements"]
        assert sf["breaker_trips"] == st["breaker_trips"]
        assert sf["role"] == "healer" and sf["breaker_threshold"] == 1.5
    finally:
        for d in made:
            d.stop()


def test_drain_death_race_reaps_the_drain_record(models):
    """begin_drain, then death: the healer reaps the corpse, finalizes
    the drain record (drains_reaped) and does not replace it."""
    from ray_tpu_torch.serve.autoscale import _Draining

    _, tp = models
    d0 = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    d1 = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    router = DisaggRouter(decode=[d0, d1], prefill=[_prefill(tp)],
                          max_queue_depth=2, affinity_tokens=BS)
    scaler = _mk_scaler(router, {
        "prefill": lambda: _prefill(tp),
        "decode": lambda: DecodeServer(tp, TCFG, max_batch=2,
                                       device="cpu")})
    try:
        assert router.begin_drain("decode", d0.server_id)
        scaler._draining.append(
            _Draining("decode", d0.server_id, time.monotonic(), 30.0))
        scaler._handle_replica_death(
            "decode", {"rid": d0.server_id, "machine": "hostX"})
        st = scaler.status()
        assert st["drains_reaped"] == 1
        assert st["draining"] == []
        assert st["replacements"]["decode"] == 0
        assert [r["rid"] for r in router.tier_replicas("decode")] \
            == [d1.server_id]
    finally:
        d0.stop()
        d1.stop()
