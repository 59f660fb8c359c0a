"""The serving autoscaler of the port (ray_tpu_torch/serve/autoscale.py)
against the JAX package's, on the CPU: Llama tiny in fp32, KV blocks of 4
tokens, every server at ``device="cpu"``.

Twins of tests/test_autoscale.py: the sliding window, a serve replica's
trailing window in its `get_metrics()`, the hysteresis /
cooldown / clamp gates, the no-flap property, the tiers' independent
signals, the TierSpec bounds over any policy, scale-to-zero with the
first arrival's wake, a burst's scale-up admitting at once, the
mid-traffic replica-set swap, the decode-host prefill affinity, and,
each in a driver process of its own (`_private/serve_checks.py` run by
`isolated.run_checks`), the zero-drop drain of a decode ACTOR and the
state-API and timeline legs of the one-set-of-numbers check.

Parity with the JAX package on the same inputs: `ScalingPolicy.decide`
over seeded random desired / current / clock streams, `DisaggPolicy.
decide` over seeded random signal snapshots, `DisaggAutoscaler.
probe_signals` on the same router state (stub replicas answering the
same free slots and speculation stats), and the timeline's autoscale
markers.

The CLI and dashboard legs of test_all_surfaces_report_consistent_
numbers (`autoscale --json` and `/api/autoscale` equal to the state
view, the event tail one scale_up, drain and scale_down) are in the
same check.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.models.llama import llama_init as jllama_init
from ray_tpu.observability import timeline as jtimeline
from ray_tpu.serve import autoscale as jas
from ray_tpu.serve import disagg as jdisagg
from ray_tpu_torch._private import isolated, serve_checks
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.observability import timeline as ttimeline
from ray_tpu_torch.serve import autoscale as tas
from ray_tpu_torch.serve import disagg as tdisagg
from ray_tpu_torch.serve.autoscale import (DisaggAutoscaler, DisaggPolicy,
                                           ScalingPolicy, SlidingWindow,
                                           TierSpec)
from ray_tpu_torch.serve.disagg import (DecodeServer, DisaggRouter,
                                        PrefillServer)

TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
JCFG = dataclasses.replace(JLlamaConfig.tiny(), dtype=jnp.float32)
BS = serve_checks.BS
CLUSTER = {"num_cpus": 4, "_system_config": serve_checks.SYSTEM_CONFIG}
CHECKS = {name: CLUSTER for name in (
    "autoscale_scale_down_drains_zero_dropped_inflight",
    "autoscale_all_surfaces_report_consistent_numbers")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.fixture(scope="module")
def model():
    jp = jllama_init(JCFG, jax.random.PRNGKey(0))
    return from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _prefill(tp, **kw):
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_pool_blocks", 32)
    return PrefillServer(tp, TCFG, device="cpu", **kw)


def _decode(tp, max_batch=1):
    return DecodeServer(tp, TCFG, max_batch=max_batch, device="cpu")


def _tiers(tp, *, n_prefill=1, n_decode=1, max_batch=1, queue_depth=0):
    prefill = [_prefill(tp) for _ in range(n_prefill)]
    decode = [_decode(tp, max_batch) for _ in range(n_decode)]
    router = DisaggRouter(decode=decode, prefill=prefill,
                          max_queue_depth=queue_depth, affinity_tokens=BS)
    return router, prefill, decode


def _stop_all(router):
    for tier in ("prefill", "decode"):
        for r in router.tier_replicas(tier):
            stop = getattr(r["target"], "stop", None)
            if callable(stop):
                stop()


class _ForcedPolicy:
    """decide() returns fixed targets, so the loop's scale-up and drain
    mechanics run without shaping real load."""

    target_p99_ms = 1500.0

    def __init__(self, targets):
        self.targets = dict(targets)

    def decide(self, signals, current, now=None):
        return {tier: (self.targets.get(tier, cur),
                       "forced" if self.targets.get(tier, cur) != cur
                       else "hold")
                for tier, cur in current.items()}


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_autoscale_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------------------ unit layer

@pytest.mark.parametrize("mod", [tas, jas], ids=["port", "jax"])
def test_sliding_window_recency_and_percentiles(mod):
    """Old samples age out (recent p99, not lifetime), the percentiles are
    the step timer's."""
    from ray_tpu.observability.step_timer import percentile

    w = mod.SlidingWindow(window_s=10.0)
    for i in range(100):
        w.add(1000.0, now=float(i) / 50.0)
    for i in range(50):
        w.add(float(i), now=20.0 + i / 50.0)
    s = w.summary(now=21.0)
    assert s["n"] == 50
    assert s["p99"] == percentile(sorted(range(50)), 0.99)
    assert s["p50"] == percentile(sorted(range(50)), 0.5)
    assert s["last"] == 49.0
    assert mod.SlidingWindow(window_s=5.0).summary() == {"n": 0}
    tiny = mod.SlidingWindow(window_s=1e9, max_samples=8)
    for i in range(100):
        tiny.add(i, now=float(i))
    assert tiny.summary(now=100.0)["n"] == 8


def test_scaling_policy_hysteresis_cooldown_and_clamps():
    p = ScalingPolicy(1, 4, up_delay_s=1.0, down_delay_s=3.0,
                      cooldown_s=2.0)
    assert p.decide(3, 1, now=0.0) == 1
    assert p.decide(3, 1, now=0.9) == 1
    assert p.decide(8, 1, now=1.1) == 4
    assert p.decide(1, 4, now=2.0) == 4
    assert p.decide(1, 4, now=4.0) == 4
    assert p.decide(1, 4, now=7.2) == 1
    assert p.decide(0, 1, now=20.0) == 1
    q = ScalingPolicy(1, 4, up_delay_s=1.0, down_delay_s=1.0,
                      cooldown_s=0.0)
    q.decide(2, 1, now=0.0)
    assert q.decide(2, 1, now=0.6) == 1
    q.decide(1, 1, now=0.7)
    assert q.decide(2, 1, now=1.3) == 1
    with pytest.raises(ValueError):
        ScalingPolicy(3, 2)


def test_scaling_policy_never_flaps_under_oscillating_signal():
    p = ScalingPolicy(1, 4, up_delay_s=2.0, down_delay_s=5.0,
                      cooldown_s=0.0)
    cur, changes = 2, 0
    for i in range(200):
        new = p.decide(3 if i % 2 == 0 else 1, cur, now=i * 0.5)
        if new != cur:
            changes += 1
            cur = new
    assert changes == 0


def test_disagg_policy_tiers_scale_on_independent_signals():
    pol = DisaggPolicy(
        target_p99_ms=100.0,
        prefill_policy=ScalingPolicy(1, 4, up_delay_s=0, down_delay_s=0,
                                     cooldown_s=0),
        decode_policy=ScalingPolicy(1, 4, up_delay_s=0, down_delay_s=0,
                                    cooldown_s=0))
    cur = {"prefill": 2, "decode": 2}
    out = pol.decide({"ttft_p99_ms": 500.0, "decode_free_p50": 3.0,
                      "decode_busy_p99": 3.0,
                      "decode_cap_per_replica": 4}, cur, now=0.0)
    assert out["prefill"][0] == 3 and "queueing" in out["prefill"][1]
    assert out["decode"][0] == 2
    out = pol.decide({"ttft_p99_ms": 60.0, "decode_free_p50": 0.0},
                     cur, now=1.0)
    assert out["decode"][0] == 3 and "exhausted" in out["decode"][1]
    assert out["prefill"][0] == 2
    out = pol.decide({"ttft_p99_ms": 10.0, "cache_hit_rate": 0.9,
                      "decode_free_p50": 3.0, "decode_busy_p99": 3.0,
                      "decode_cap_per_replica": 4}, cur, now=2.0)
    assert out["prefill"][0] == 1 and "hit rate" in out["prefill"][1]
    out = pol.decide({"decode_free_p50": 7.0, "decode_busy_p99": 1.0,
                      "decode_cap_per_replica": 4}, cur, now=3.0)
    assert out["decode"][0] == 1
    out = pol.decide({}, cur, now=4.0)
    assert out["prefill"][0] == 1 and "idle" in out["prefill"][1]
    out = pol.decide({}, {"prefill": 1, "decode": 2}, now=5.0)
    assert out["prefill"][0] == 1 and out["decode"][0] == 2


def test_knobs_are_arguments_at_the_jax_defaults():
    """The JAX package's environment knobs, as the port's arguments."""
    p = ScalingPolicy()
    assert (p.up_delay_s, p.down_delay_s, p.cooldown_s) == (2.0, 10.0, 5.0)
    jp = jas.ScalingPolicy()
    assert (jp.up_delay_s, jp.down_delay_s, jp.cooldown_s) \
        == (p.up_delay_s, p.down_delay_s, p.cooldown_s)
    assert DisaggPolicy().target_p99_ms == jas.default_target_p99_ms()
    assert SlidingWindow().window_s == jas.SlidingWindow().window_s


# ------------------------------------------------------------ parity

@pytest.mark.parametrize("seed", range(3))
def test_scaling_policy_matches_jax_on_random_streams(seed):
    """Seeded random (desired, current, clock) streams through both
    packages' ScalingPolicy give the same targets."""
    rng = np.random.default_rng(seed)
    kw = dict(up_delay_s=float(rng.uniform(0, 2)),
              down_delay_s=float(rng.uniform(0, 4)),
              cooldown_s=float(rng.uniform(0, 2)))
    t, j = ScalingPolicy(1, 5, **kw), jas.ScalingPolicy(1, 5, **kw)
    now, cur = 0.0, 2
    for _ in range(400):
        now += float(rng.uniform(0, 0.7))
        desired = int(rng.integers(0, 8))
        got, want = t.decide(desired, cur, now), j.decide(desired, cur, now)
        assert got == want
        if rng.random() < 0.8:
            cur = got


def _random_signals(rng):
    sig = {}
    for key, lo, hi in (("ttft_p99_ms", 0.0, 3000.0),
                        ("cache_hit_rate", 0.0, 1.0),
                        ("prefill_inflight_p99", 0.0, 6.0),
                        ("decode_free_p50", 0.0, 8.0),
                        ("decode_busy_p99", 0.0, 12.0),
                        ("queue_depth_p99", 0.0, 30.0),
                        ("spec_tokens_per_verify", 0.0, 4.0)):
        if rng.random() < 0.7:
            v = float(rng.uniform(lo, hi))
            sig[key] = float(np.round(v)) if rng.random() < 0.3 else v
    if rng.random() < 0.8:
        sig["decode_cap_per_replica"] = int(rng.integers(1, 6))
    return sig


@pytest.mark.parametrize("seed", range(3))
def test_disagg_policy_matches_jax_on_random_signals(seed):
    """Seeded random signal snapshots and tier counts: both packages'
    DisaggPolicy decide the same (target, reason) per tier, hysteresis
    included."""
    rng = np.random.default_rng(100 + seed)

    def policies(mod):
        kw = dict(up_delay_s=0.5, down_delay_s=1.0, cooldown_s=0.3)
        return mod.DisaggPolicy(
            target_p99_ms=800.0,
            prefill_policy=mod.ScalingPolicy(0, 4, **kw),
            decode_policy=mod.ScalingPolicy(1, 5, **kw))

    t, j = policies(tas), policies(jas)
    now = 0.0
    for _ in range(300):
        now += float(rng.uniform(0, 0.4))
        sig = _random_signals(rng)
        cur = {"prefill": int(rng.integers(0, 5)),
               "decode": int(rng.integers(1, 6))}
        assert t.decide(dict(sig), dict(cur), now) \
            == j.decide(dict(sig), dict(cur), now)
        for tier in ("prefill", "decode"):
            fn = f"desired_{tier}"
            assert getattr(t, fn)(dict(sig), cur[tier]) \
                == getattr(j, fn)(dict(sig), cur[tier])


class _StubReplica:
    """A tier replica that answers describe / free_slots / stats from
    fixed values: the same state for both packages' routers."""

    def __init__(self, sid, cap, free, tokens_per_verify=None):
        self.sid, self.cap, self.free = sid, cap, free
        self.tpv = tokens_per_verify

    def describe(self):
        return {"server_id": self.sid, "capacity": self.cap,
                "machine": "host-a"}

    def capacity(self):
        return self.cap

    def free_slots(self):
        return self.free

    def set_retention(self, n):
        return None

    def stats(self):
        if self.tpv is None:
            return {"held_transfers": 0}
        return {"speculation": {"spec_verify_ticks": 5,
                                "tokens_per_verify": self.tpv}}


@pytest.mark.parametrize("spec", [None, (2.5, 1.5)],
                         ids=["plain", "speculating"])
def test_probe_signals_matches_jax_on_same_router_state(spec):
    """Both packages' DisaggAutoscaler.probe_signals over routers holding
    the same window samples and stub replicas return the same
    snapshot."""
    rng = np.random.default_rng(7)
    frees = [1, 3]
    tpv = spec or (None, None)

    def build(dmod, amod):
        decode = [_StubReplica(f"d{i}", 4, frees[i], tpv[i])
                  for i in range(2)]
        router = dmod.DisaggRouter(decode=decode,
                                   prefill=[_StubReplica("p0", 0, 0)],
                                   affinity_tokens=BS)
        scaler = amod.DisaggAutoscaler(
            router, prefill=amod.TierSpec(lambda: None),
            decode=amod.TierSpec(lambda: None), interval_s=3600.0)
        return router, scaler

    (tr, ts), (jr, js) = build(tdisagg, tas), build(jdisagg, jas)
    now = time.monotonic()
    samples = {name: rng.uniform(0, 100, 20).tolist()
               for name in ("_ttft_win", "_depth_win", "_pf_inflight_win",
                            "_cache_win")}
    for name, vals in samples.items():
        for i, v in enumerate(vals):
            for r in (tr, jr):
                getattr(r, name).add(v, now=now - 1.0 + i * 0.01)
    for k in range(3):
        t_now = now + k * 0.5
        got, want = ts.probe_signals(t_now), js.probe_signals(t_now)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                       atol=2e-5, err_msg=key)
    assert ("spec_tokens_per_verify" in got) == (spec is not None)


def test_autoscale_trace_events_match_jax():
    events = [{"kind": "scale_up", "tier": "decode", "to": 2,
               "replica": "d1", "ts": 1.5, "autoscaler": "a"},
              {"kind": "drain", "tier": "prefill", "to": 1, "ts": 2.0,
               "inflight": 0, "reason": None},
              {"kind": "replica_death", "tier": "decode", "ts": 3.0},
              {"kind": "no_ts"}]
    assert ttimeline.autoscale_trace_events(events) \
        == jtimeline.autoscale_trace_events(events)


# ------------------------------------------------- the loop, real tiers


def test_replica_recent_window_in_get_metrics():
    """serve/replica.py reports trailing-window latency beside the
    lifetime counters, from serve/autoscale.py's SlidingWindow."""
    import cloudpickle

    from ray_tpu_torch.serve.replica import ReplicaActor

    rep = ReplicaActor("t#r#1", "dep", "app",
                       cloudpickle.dumps(lambda x: x),
                       cloudpickle.dumps(((), {})))
    for i in range(5):
        assert rep.handle_request({}, [i], {}) == i
    m = rep.get_metrics()
    assert m["num_requests"] == 5
    rec = m["recent"]["latency_ms"]
    assert rec["n"] == 5 and rec["p99"] >= rec["p50"] >= 0.0
    assert isinstance(rep._recent_latency, SlidingWindow)


def test_tier_spec_bounds_cap_any_policy(model):
    router, _, _ = _tiers(model, max_batch=1, queue_depth=1)
    scaler = DisaggAutoscaler(
        router,
        prefill=TierSpec(lambda: _prefill(model), min_replicas=1,
                         max_replicas=1),
        decode=TierSpec(lambda: _decode(model), min_replicas=1,
                        max_replicas=2),
        policy=_ForcedPolicy({"decode": 4, "prefill": 4}),
        interval_s=3600, drain_grace_s=10)
    try:
        for _ in range(3):
            scaler.tick()
        assert len(router.tier_replicas("decode")) == 2
        assert len(router.tier_replicas("prefill")) == 1
    finally:
        _stop_all(router)


def test_scale_to_zero_and_first_arrival_wake(model):
    router, _, _ = _tiers(model, max_batch=2, queue_depth=2)
    scaler = DisaggAutoscaler(
        router,
        prefill=TierSpec(lambda: _prefill(model), min_replicas=1,
                         max_replicas=2),
        decode=TierSpec(lambda: _decode(model, 2), min_replicas=0,
                        max_replicas=2, down_delay_s=1.0, cooldown_s=0.5),
        interval_s=3600, drain_grace_s=5.0,
        autoscaler_id="scale-to-zero-test")
    try:
        now = time.monotonic()
        acts = []
        for i in range(10):
            acts += scaler.tick(now + i * 1.0)
        deadline = time.monotonic() + 15.0
        while router.tier_replicas("decode") and \
                time.monotonic() < deadline:
            acts += scaler.tick(time.monotonic() + 20.0)
            time.sleep(0.1)
        assert router.tier_replicas("decode") == [], acts
        assert any(a["kind"] == "drain" and a["tier"] == "decode"
                   for a in acts)
        prompt = np.random.default_rng(5).integers(
            1, TCFG.vocab_size, 10).tolist()
        out = router.generate(prompt, 6)
        assert len(out) == 6
        assert len(router.tier_replicas("decode")) == 1
        assert scaler.status()["wakeups"]["decode"] == 1
        assert router.stats()["tier_wakeups"] == 1
        assert len(router.tier_replicas("prefill")) >= 1
    finally:
        scaler.stop()
        _stop_all(router)


def test_scale_up_on_burst_admits_immediately(model):
    router, _, _ = _tiers(model, max_batch=1, queue_depth=1)
    spec = dict(min_replicas=1, max_replicas=2, up_delay_s=0,
                down_delay_s=3600, cooldown_s=0)
    scaler = DisaggAutoscaler(
        router, prefill=TierSpec(lambda: _prefill(model), **spec),
        decode=TierSpec(lambda: _decode(model), **spec),
        interval_s=3600, drain_grace_s=10)
    shared = [11, 12, 13, 14, 15, 16, 17, 18]
    router.generate(shared, 2)
    admitted = [threading.Event(), threading.Event()]
    done = {}

    def _slow(i):
        done[i] = router.generate(shared + [70 + i], 8,
                                  on_first_token=admitted[i].set,
                                  token_sleep_s=0.3)

    threads = [threading.Thread(target=_slow, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for ev in admitted:
            assert ev.wait(30.0)
        actions = scaler.tick()
        assert all(a["kind"] == "scale_up" for a in actions)
        assert any(a["tier"] == "decode" for a in actions)
        assert len(router.tier_replicas("decode")) == 2
        assert len(router.generate(shared + [1], 3)) == 3
        assert router.stats()["shed"] == 0
        for t in threads:
            t.join(timeout=120)
        assert sorted(len(v) for v in done.values()) == [8, 8]
    finally:
        for t in threads:
            t.join(timeout=60)
        _stop_all(router)


def test_mid_traffic_replica_set_swap_bit_identity(model):
    colo = ContinuousBatchingEngine(model, TCFG, max_batch=4,
                                    kv_block_size=BS, kv_pool_blocks=32)
    router, _, _ = _tiers(model, max_batch=2, queue_depth=4)
    prompts = [[31, 32, 33, 34, 35, 36, 37, 38] + [50 + i]
               for i in range(8)]
    try:
        want = [colo.generate(p, 5) for p in prompts]
        got = [router.generate(prompts[0], 5),
               router.generate(prompts[1], 5)]
        d_new = router.add_decode(_decode(model, 2))
        got.append(router.generate(prompts[2], 5))
        p_new = router.add_prefill(_prefill(model))
        got.append(router.generate(prompts[3], 5))
        old_dec = [r["rid"] for r in router.tier_replicas("decode")
                   if r["rid"] != d_new]
        old_pf = [r["rid"] for r in router.tier_replicas("prefill")
                  if r["rid"] != p_new]
        assert router.begin_drain("decode", old_dec[0])
        assert router.begin_drain("prefill", old_pf[0])
        got.append(router.generate(prompts[4], 5))
        deadline = time.monotonic() + 30.0
        while not (router.drained("decode", old_dec[0])
                   and router.drained("prefill", old_pf[0])):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        for tier, rid in (("decode", old_dec[0]), ("prefill", old_pf[0])):
            gone = router.remove(tier, rid)
            stop = getattr(gone, "stop", None)
            if callable(stop):
                stop()
        got.extend(router.generate(p, 5) for p in prompts[5:])
        assert got == want
        st = router.stats()
        assert st["decode_replicas"] == 1 and st["prefill_replicas"] == 1
        assert st["completed"] == st["dispatched"] and st["shed"] == 0
        assert st["recent"]["ttft_ms"]["n"] >= len(prompts)
        assert st["recent"]["cache_hit_rate"]["n"] >= len(prompts)
    finally:
        colo.stop()
        _stop_all(router)


def test_prefill_affinity_prefers_decode_host(model):
    router, _, decode = _tiers(model, n_prefill=2, max_batch=2,
                               queue_depth=2)
    reps = router._prefill
    router._decode[0].machine = "here"
    reps[0].machine = "elsewhere"
    reps[1].machine = "here"
    prompt = np.asarray([1, 2, 3, 4, 5], np.int32)
    for _ in range(4):
        assert router._pick_prefill(prompt, "here") == (reps[1], None)
    fallback, hint = router._pick_prefill(prompt, "mars")
    assert fallback in reps and hint is None
    assert router._pick_prefill(prompt, "mars") == (fallback, None)
    st = router.stats()
    assert st["shm_affinity_total"] == 6
    assert st["shm_affinity_hits"] == 4
    assert st["shm_affinity_hit_rate"] == round(4 / 6, 4)
    for r in decode:
        r.stop()
