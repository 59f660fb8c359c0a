"""The online learning loop's checks that need a cluster, run by
`isolated.run_checks` in a driver process of their own, as
`fabric_checks.py`'s are (tests/test_torch_online.py makes each one a
test case).

Each is a twin of a case of the JAX package's tests/test_online.py, named
after it: the weight fabric's delta publication, delta chains across GC,
a rapid publication cadence followed within one version, the sync's
unreachable-registry flag, prefetch and same-host accounting, the rollout
buffer, a sampler in this process, and the online-distillation loop end
to end (its state-API and timeline legs). The JAX cases publish trees
sharded over an 8-device CPU mesh; here the trees are plain CPU tensors
(the sharded layouts are tests/test_torch_weights.py's gang cases). A
check that returns a value has it as JSON in its outcome.

This module imports no torch at the top: the fork template must not.
"""
from __future__ import annotations

import threading
import time

import numpy as np

import ray_tpu_torch as rt

from .cluster_checks import _conductor, _wait_until

# the JAX fixture's cluster: keep the last 3 versions of a weight set
ONLINE_CONFIG = {"log_to_driver": 0, "weights_keep": 3}


def _tree(seed=0):
    """tests/test_online.py `_tree` as plain CPU tensors."""
    import torch

    rng = np.random.default_rng(seed)
    return {"w_big": torch.from_numpy(
                rng.standard_normal((64, 16)).astype(np.float32)),
            "w_col": torch.from_numpy(
                rng.standard_normal((4, 32)).astype(np.float32)),
            "bias": torch.from_numpy(
                rng.standard_normal(16).astype(np.float32))}


def tiny_gpt2_config():
    import dataclasses

    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config

    return dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)


def tiny_gpt2_factory():
    """(template params, config): GPT-2 tiny fp32 from seed 0 on the CPU,
    what a sampler's model_factory returns."""
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_init

    cfg = tiny_gpt2_config()
    return gpt2_init(cfg, torch.Generator().manual_seed(0),
                     device="cpu"), cfg


class _FakeEngine:
    """The least WeightSync drives: update_params + params_version,
    swapping at once."""

    def __init__(self, params=None, version=None):
        self.params = params
        self.params_version = version
        self.swap_count = 0

    def update_params(self, params, version=None):
        self.params = params
        self.params_version = version
        self.swap_count += 1
        ev = threading.Event()
        ev.set()
        return ev


def _manifest(name, version):
    return _conductor().call("weights_get_manifest", name, version,
                             timeout=10.0)


# ---------------------------------------------- delta: what ships

def online_delta_publish_ships_only_changed_leaves():
    """A delta publish records (base_version, changed_leaves), ships fewer
    bytes than a full one, inherits the unchanged leaves' chunks and
    fetches bit-identically, also under a dtype-cast template."""
    import torch

    from ray_tpu_torch import weights as wts

    pub = wts.WeightPublisher("delta-basic")
    t1 = _tree(1)
    pub.publish(t1, step=1, delta=True)  # no base: full, seeds the chain
    t2 = dict(t1, w_big=t1["w_big"] * 1.5)
    assert pub.publish(t2, step=2, delta=True) == 2
    m1, m2 = _manifest("delta-basic", 1), _manifest("delta-basic", 2)
    assert not m1["delta"]
    assert m2["delta"] and m2["base_version"] == 1
    # the JAX package's leaf order: sorted keys
    assert m2["changed_leaves"] == [
        i for i, k in enumerate(sorted(t1)) if k == "w_big"]
    assert 0 < m2["delta_bytes"] < m2["total_bytes"]
    assert m2["total_bytes"] == m1["total_bytes"]
    by_shape = {tuple(lf["shape"]): lf for lf in m2["leaves"]}
    base_by_shape = {tuple(lf["shape"]): lf for lf in m1["leaves"]}
    same = {s["object_id"] for s in by_shape[(4, 32)]["shards"]}
    assert same == {s["object_id"] for s in base_by_shape[(4, 32)]["shards"]}
    new = {s["object_id"] for s in by_shape[(64, 16)]["shards"]}
    assert not new & {s["object_id"]
                      for s in base_by_shape[(64, 16)]["shards"]}
    sub = wts.WeightSubscriber("delta-basic")
    out = sub.fetch(version=2)
    np.testing.assert_array_equal(out["w_big"], t2["w_big"].numpy())
    np.testing.assert_array_equal(out["w_col"], t1["w_col"].numpy())
    assert sub.last_stats.delta and sub.last_stats.base_version == 1
    like = {"w_big": torch.zeros(64, 16, dtype=torch.float16),
            "w_col": torch.zeros(4, 32), "bias": torch.zeros(16)}
    cast = sub.fetch(version=2, like=like)
    assert cast["w_big"].dtype == torch.float16
    assert torch.equal(cast["w_big"], t2["w_big"].to(torch.float16))
    sub.close()
    pub.close()
    return {"delta_bytes": m2["delta_bytes"],
            "total_bytes": m2["total_bytes"]}


def online_delta_chain_resolves_across_gcd_bases():
    """Chains of deltas collapse at commit: a kept version stays
    fetchable after its bases were GC'd, and a delta against a fully GC'd
    base goes out full."""
    from ray_tpu_torch import weights as wts

    pub = wts.WeightPublisher("delta-chain")
    trees = [_tree(1)]
    pub.publish(trees[0], step=1, delta=True)
    for v in range(2, 5):
        t = dict(trees[-1], w_big=trees[-1]["w_big"] + v)
        trees.append(t)
        assert pub.publish(t, step=v, delta=True) == v
    listing = _conductor().call("get_weight_versions", timeout=10.0)
    kept = [x["version"] for x in listing["names"]["delta-chain"]["versions"]]
    assert kept == [2, 3, 4], kept
    sub = wts.WeightSubscriber("delta-chain")
    for v in (2, 4):
        out = sub.fetch(version=v)
        np.testing.assert_array_equal(out["w_big"],
                                      trees[v - 1]["w_big"].numpy())
        np.testing.assert_array_equal(out["w_col"],
                                      trees[0]["w_col"].numpy())
    assert _conductor().call("weights_gc", "delta-chain", 0,
                             timeout=10.0) == 3
    assert pub.publish(trees[-1], step=5, delta=True) == 5
    m5 = _manifest("delta-chain", 5)
    assert not m5["delta"] and m5["base_version"] is None
    out = sub.fetch(version=5)
    np.testing.assert_array_equal(out["w_big"], trees[-1]["w_big"].numpy())
    sub.close()
    pub.close()


# ------------------------------------------- cadence and staleness

def online_rapid_cadence_publication():
    """20 versions ~50 ms apart: keep-last-K GC holds, delta chains
    resolve across the churn, and a WeightSync-driven engine never falls
    more than one version behind."""
    from ray_tpu_torch import weights as wts

    pub = wts.WeightPublisher("rapid")
    t = _tree(7)
    pub.publish(t, step=1, delta=True)
    engine = _FakeEngine()
    sync = wts.WeightSync(engine, "rapid", template=t,
                          consumer="rapid-engine", poll_interval_s=0.015)
    try:
        sync.wait_for_swap(1, timeout=30.0)
        for v in range(2, 21):
            t = dict(t, w_big=t["w_big"] + 1.0)
            pub.publish(t, step=v, delta=True)
            time.sleep(0.05)
        sync.wait_for_swap(20, timeout=30.0)
        assert sync.max_staleness is not None and sync.max_staleness <= 1, \
            sync.max_staleness
        st = sync.status()
        assert st["max_staleness_versions"] <= 1
        assert st["staleness_versions"] == 0
        listing = _conductor().call("get_weight_versions", timeout=10.0)
        kept = [x["version"] for x in listing["names"]["rapid"]["versions"]]
        assert kept == [18, 19, 20], kept
        np.testing.assert_array_equal(np.asarray(engine.params["w_big"]),
                                      t["w_big"].numpy())
    finally:
        sync.stop()
    pub.close()
    return {"max_staleness": sync.max_staleness}


def online_sync_registry_unreachable_flag():
    """An unreachable registry shows as registry_reachable=False with the
    staleness unknown (None), never as fresh; it recovers."""
    from ray_tpu_torch import weights as wts

    t = _tree(9)
    wts.publish(t, name="reach", step=1)
    engine = _FakeEngine()
    sync = wts.WeightSync(engine, "reach", template=t,
                          consumer="reach-engine", poll_interval_s=0.02)
    try:
        sync.wait_for_swap(1, timeout=30.0)
        st = sync.status()
        assert st["registry_reachable"] is True
        assert st["staleness_versions"] == 0
        real = sync._sub.latest_version

        def boom():
            raise ConnectionError("conductor unreachable")

        sync._sub.latest_version = boom
        try:
            _wait_until(lambda: not sync.status()["registry_reachable"],
                        10.0, "the flag never dropped")
            st = sync.status()
            assert st["registry_reachable"] is False
            assert st["staleness_versions"] is None
            assert st["last_error"] and "unreachable" in st["last_error"]
            assert st["serving_version"] == 1
        finally:
            sync._sub.latest_version = real
        _wait_until(lambda: sync.status()["registry_reachable"], 10.0,
                    "the flag never recovered")
        assert sync.status()["staleness_versions"] == 0
    finally:
        sync.stop()


# ----------------------------- prefetch and same-host accounting

class _Producer:
    """Publishes v1 (full) in its own process, then a delta v2."""

    def __init__(self):
        import torch

        from ray_tpu_torch import weights as wts_mod

        self.pub = wts_mod.WeightPublisher("pf")
        rng = np.random.default_rng(3)
        self.t1 = {"big": torch.from_numpy(
                       rng.standard_normal((256, 64)).astype(np.float32)),
                   "small": torch.from_numpy(
                       rng.standard_normal(16).astype(np.float32))}
        self.pub.publish(self.t1, step=1, delta=True)

    def publish_delta(self):
        self.pub.publish(dict(self.t1, small=self.t1["small"] + 1.0),
                         step=2, delta=True)
        return True

    def tree(self):
        return {k: v.numpy() for k, v in self.t1.items()}


def online_prefetch_and_delta_fetch_bytes():
    """Chunks in another process's store: prefetch pulls them while
    nothing waits, the fetch after it moves 0 bytes, a delta version's
    fetch moves only the changed leaf, all over shm."""
    from ray_tpu_torch import weights as wts

    prod = rt.remote(_Producer).remote()
    sub = wts.WeightSubscriber("pf")
    assert sub.wait_for_version(1, timeout=60.0) == 1
    pf = sub.prefetch(version=1)
    assert pf.fetched_bytes > 0 and pf.chunks_fetched == 2
    assert pf.shm_bytes == pf.fetched_bytes and pf.rpc_bytes == 0
    out = sub.fetch(version=1)
    full_stats = sub.last_stats
    assert full_stats.fetched_bytes == 0
    assert full_stats.chunks_local == 2
    expected = rt.get(prod.tree.remote(), timeout=30.0)
    np.testing.assert_array_equal(out["big"], expected["big"])
    assert rt.get(prod.publish_delta.remote(), timeout=60.0)
    assert sub.wait_for_version(2, timeout=30.0) == 2
    sub.fetch(version=2)
    delta_stats = sub.last_stats
    assert delta_stats.delta and delta_stats.base_version == 1
    assert delta_stats.fetched_bytes == 16 * 4
    assert delta_stats.fetched_bytes < pf.fetched_bytes
    assert delta_stats.rpc_bytes == 0
    kinds = [e["kind"] for e in _conductor().call(
        "get_weight_events", 200, timeout=10.0) if e.get("name") == "pf"]
    assert "prefetch" in kinds, kinds
    sub.close()
    rt.kill(prod)


class _Holder:
    def hold(self):
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.util import chunks

        self.ref, entry = chunks.put_chunk(worker_mod.global_worker,
                                           np.arange(64, dtype=np.float32))
        return entry


def online_chunk_fetcher_shm_vs_rpc_accounting():
    """A same-host pull accounts as shm, an entry claiming another
    machine as rpc; a seeded fetcher reads it as local."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util import chunks

    holder = rt.remote(_Holder).remote()
    entry = rt.get(holder.hold.remote(), timeout=60.0)
    assert entry["machine"] == chunks.local_machine_id()
    w = worker_mod.global_worker
    f1 = chunks.ChunkFetcher(w)
    f1(dict(entry, machine="some-other-host/boot-id"))
    assert f1.rpc_bytes == 64 * 4 and f1.shm_bytes == 0
    f2 = chunks.ChunkFetcher(w)
    f2(entry)
    assert f2.chunks_fetched == 1 and f2.shm_bytes == 64 * 4
    assert f2.rpc_bytes == 0
    f3 = chunks.ChunkFetcher(w, seed_cache=f2.cache)
    np.testing.assert_array_equal(f3(entry), np.arange(64, dtype=np.float32))
    assert f3.chunks_local == 1 and f3.fetched_bytes == 0
    rt.kill(holder)


# ----------------------------------------------------- rollout buffer

def online_rollout_buffer_backpressure_and_versions():
    """Bounded capacity with put-side rejection, FIFO pops, version-tagged
    occupancy, and streaming_split shards popping disjoint batches."""
    from ray_tpu_torch.online import RolloutBuffer, from_rollouts

    buf = rt.remote(RolloutBuffer).remote(4, name="bp-test")

    def item(i, v):
        return {"id": i, "weights_version": v}

    assert rt.get(buf.put.remote([item(i, 1) for i in range(3)]),
                  timeout=30.0) == 3
    assert rt.get(buf.put.remote([item(i, 2) for i in range(3, 6)]),
                  timeout=30.0) == 1
    st = rt.get(buf.stats.remote(), timeout=30.0)
    assert st["occupancy"] == 4 and st["capacity"] == 4
    assert st["rejected"] == 2
    assert st["versions_queued"] == {1: 3, 2: 1}
    got = rt.get(buf.get_batch.remote(2), timeout=30.0)
    assert [r["id"] for r in got] == [0, 1]
    st = rt.get(buf.stats.remote(), timeout=30.0)
    assert st["occupancy"] == 2 and st["versions_queued"] == {1: 1, 2: 1}
    assert rt.get(buf.put.remote([item(i, 3) for i in range(6, 8)]),
                  timeout=30.0) == 2
    shards = from_rollouts(buf, batch_size=2, prefetch=0).streaming_split(2)
    seen = [r["id"] for r in next(shards[0].iter_batches())] \
        + [r["id"] for r in next(shards[1].iter_batches())]
    assert sorted(seen) == [2, 3, 6, 7]
    rt.kill(buf)
    return {"seen": sorted(seen)}


def online_rollout_sampler_inprocess():
    """A RolloutSampler in this process against a published v1: the
    rollout carries aligned per-token logprobs (<= 0) and the version."""
    from ray_tpu_torch import weights as wts
    from ray_tpu_torch.online import RolloutBuffer, RolloutSampler

    params, cfg = tiny_gpt2_factory()
    wts.publish(params, name="samp", step=1)
    buf = rt.remote(RolloutBuffer).remote(8, name="samp-buf")
    sampler = RolloutSampler("samp-0", "samp", tiny_gpt2_factory, buf,
                             max_new_tokens=6, prefetch=False, device="cpu")
    try:
        r = sampler._rollout_one()
        assert r["weights_version"] == 1
        assert r["completion"].shape == r["scores"].shape
        assert len(r["completion"]) == 6
        assert np.all(r["scores"] <= 0.0)
        assert np.all(np.isfinite(r["scores"]))
        st = sampler.status()
        assert st["rollouts"] == 1 and st["rollout_tokens"] == 6
        assert st["staleness_versions"] == 0
    finally:
        sampler.stop()
    rt.kill(buf)
    return {"prompt": r["prompt"].tolist(),
            "completion": r["completion"].tolist(),
            "scores": r["scores"].tolist()}


# ------------------------------------------------------- the e2e loop

def online_distillation_e2e():
    """The learner (in this driver) trains while 2 sampler actors
    generate: staleness <= 1 for the whole run, the loss falls, delta
    publications ship fewer bytes than full ones, rollouts flow samplers
    -> buffer -> learner, `wpe` (frozen) is the same in every version,
    and online_status() and the timeline's online lane carry the loop's
    numbers."""
    import tempfile

    import torch

    from ray_tpu_torch import weights as wts
    from ray_tpu_torch.observability import timeline
    from ray_tpu_torch.online import OnlineConfig, OnlineTrainer
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.util import state

    storage = tempfile.mkdtemp(prefix="online-e2e-")
    trainer = OnlineTrainer(tiny_gpt2_config(), config=OnlineConfig(
        num_samplers=2, num_steps=10, batch_size=8, publish_every=2,
        max_new_tokens=8, buffer_capacity=32, weights_name="e2e"),
        run_config=RunConfig(name="online-e2e", storage_path=storage),
        device="cpu", sampler_device="cpu")
    res = trainer.fit()
    assert res.error is None, res.error
    losses = [m["loss"] for m in res.metrics_history if "loss" in m]
    assert len(losses) == 10
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert len(res.sampler_stats) == 2
    for st in res.sampler_stats:
        assert st["max_staleness_versions"] is not None
        assert st["max_staleness_versions"] <= 1, st
        assert st["rollouts"] > 0 and st["swap_count"] >= 1, st
        assert st["rpc_bytes"] == 0
        assert st["registry_reachable"] is True
        assert st["run_error"] is None, st
    versions = res.weight_versions["names"]["e2e"]["versions"]
    deltas = [v for v in versions if v["delta"]]
    assert deltas, versions
    for v in deltas:
        assert 0 < v["delta_bytes"] < v["total_bytes"], v
    assert res.buffer_stats["total_in"] >= res.buffer_stats["total_out"]
    assert res.buffer_stats["total_out"] >= 80
    assert res.metrics_history[-1]["ingested_rollouts"] == 80
    # the frozen leaf is the same in every kept version
    sub = wts.WeightSubscriber("e2e")
    wpe = [sub.fetch(version=v["version"])["wpe"] for v in versions]
    sub.close()
    assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(wpe[0]))
               for x in wpe)

    def landed():
        api = state.online_status()
        mine = [v for v in api["samplers"].values()
                if v.get("weights_name") == "e2e"]
        return len(mine) == 2 and api["totals"]["learner_steps"] == 10

    _wait_until(landed, 10.0, "online_status never caught up")
    api = state.online_status()
    assert api["totals"]["max_staleness_versions"] <= 1
    assert api["totals"]["ingested_rollouts"] == 80
    assert api["totals"]["rollouts"] == sum(s["rollouts"]
                                            for s in res.sampler_stats)
    assert api["totals"]["published_versions"] == max(
        v["version"] for v in versions)
    trace = timeline.merged_timeline()
    kinds = {e["args"]["kind"] for e in trace if e.get("cat") == "online"}
    assert {"rollout", "ingest", "publish", "swap"} <= kinds, kinds
    wkinds = {e["tid"] for e in trace if e.get("cat") == "weights"}
    assert {"publish", "swap"} <= wkinds, wkinds
    return {"losses": losses,
            "max_staleness": api["totals"]["max_staleness_versions"]}

