"""The weight fabric's and the trainer's workers-mode checks, run by
`isolated.run_checks` in a driver process of their own, as
`runtime_checks.py`'s and `cluster_checks.py`'s are (tests/
test_torch_weights.py, test_torch_train_gang.py and test_torch_lora.py
make each one a test case).

Most are twins of the JAX package's tests of the same layer
(tests/test_weights.py, test_train_gang.py, test_resilience.py,
test_lora.py), one function per case, named after its file and case.
The `port_*` ones check where the port differs or what the JAX tests
leave implicit: bf16 chunks and delta publication, a GC'd version's
chunks leaving the producer's store, a rank's device following its
lease, a rank dying inside a collective, GPT-2 tiny trained by a gang
against the one-process step with a chaos restart. A check that returns
a value has it recorded as JSON in its outcome's text, for the test to
compare with the JAX package's result.

The training functions the gangs run live here too: a rank imports the
module of what it runs, and the test modules import JAX. This module
imports no torch at the top.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

import ray_tpu_torch as rt

from .cluster_checks import _conductor, _wait_until
from .runtime_checks import _raises, _worker

N_STEPS = 8
# `weights_keep` of every weights check's cluster (isolated runs pass it)
WEIGHTS_CONFIG = {"weights_keep": 2}


def _tree(seed=0, scale=1.0):
    """tests/test_weights.py `_tree` as plain CPU tensors."""
    import torch

    rng = np.random.default_rng(seed)
    return {
        "w_big": torch.from_numpy((rng.standard_normal((64, 16)) * scale)
                                  .astype(np.float32)),
        "w_col": torch.from_numpy(rng.standard_normal((4, 32))
                                  .astype(np.float32)),
        "bias": torch.from_numpy(rng.standard_normal(16)
                                 .astype(np.float32)),
        "step": torch.tensor(7, dtype=torch.int32)}


def _tiny_gpt2(seed: int = 0, scale: float = 1.0):
    """GPT-2 tiny fp32 (2 heads) on the CPU from a seed."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.tree import tree_map

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(), num_heads=2,
                              dtype=torch.float32)
    params = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    if scale != 1.0:
        params = tree_map(lambda p: p * scale, params)
    return cfg, params


# ------------------------------------------------- tests/test_weights.py

def weights_publish_fetch_reshard_roundtrip():
    """(dp, fsdp)-published weights fetched under a (tp,) layout on a
    4-rank gloo gang whose ranks are drivers of this cluster: values
    equal, the template's layout, no read larger than a rank's block of
    a sharded leaf (`weights_gang_checks.sharded_roundtrip`)."""
    from ray_tpu_torch.parallel import gang

    from . import weights_gang_checks as gang_checks

    host, port = _worker().conductor_address
    outs = gang.run_gang(gang_checks.sharded_roundtrip, 4,
                         args=(f"{host}:{port}",), timeout=150.0)
    for out in outs:
        assert out["version"] == gang_checks.VERSION
        assert out["num_hosts"] == 4
        # every rank's block of the row-split leaf, and nothing more
        assert out["big_shards"] == 4
        assert out["big_shard_bytes"] == [64 * 16 * 4 // 4] * 4
        assert out["big_max_read_bytes"] == 64 * 16 * 4 // 4
    return outs[0]


def weights_fetch_without_template_returns_numpy():
    from ray_tpu_torch import weights as wts

    state = _tree(seed=5)
    wts.publish(state, name="plain", step=1)
    sub = wts.WeightSubscriber("plain")
    out = sub.fetch()
    assert isinstance(out["w_big"], np.ndarray)
    np.testing.assert_array_equal(out["w_big"], state["w_big"].numpy())
    assert int(out["step"]) == 7
    sub.close()


def _half(real, lo, hi):
    """A snapshot function giving rows [lo, hi) of each 2-D leaf: one
    host's share of a row-split publish."""
    def snap(leaf):
        meta, shards = real(leaf)
        if len(meta["shape"]) == 2:
            shards = [(((lo, hi, 1),) + tuple(idx[1:]), arr[lo:hi])
                      for idx, arr in shards]
        return meta, shards
    return snap


def weights_multi_host_fragments_merge():
    """Two per-host publishers (each with its own half of the rows)
    commit ONE joint version; it is invisible until the last fragment
    lands."""
    import torch

    from ray_tpu_torch import weights as wts
    from ray_tpu_torch.weights import publisher as pub_mod

    full = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    arr = torch.from_numpy(full)
    real = pub_mod._leaf_snapshots
    host0 = wts.WeightPublisher("joint", host_rank=0, num_hosts=2)
    host1 = wts.WeightPublisher("joint", host_rank=1, num_hosts=2)
    sub = wts.WeightSubscriber("joint")
    try:
        pub_mod._leaf_snapshots = _half(real, 0, 32)
        host0.publish({"w": arr}, step=1)
        assert sub.latest_version() is None
        listing = _conductor().call("get_weight_versions", timeout=10.0)
        assert [p["version"] for p in listing["pending"]] == [1]
        pub_mod._leaf_snapshots = _half(real, 32, 64)
        host1.publish({"w": arr}, step=1)
    finally:
        pub_mod._leaf_snapshots = real
    assert sub.wait_for_version(1, timeout=10.0) == 1
    manifest = _conductor().call("weights_get_manifest", "joint", 1,
                                 timeout=10.0)
    assert manifest["num_hosts"] == 2
    assert len(manifest["leaves"][0]["shards"]) == 2
    out = sub.fetch(like={"w": torch.zeros(64, 8)})
    np.testing.assert_array_equal(out["w"].numpy(), full)
    for p in (host0, host1):
        p.close()
    sub.close()


def weights_version_gc_keeps_exactly_k():
    """weights_keep=2: the registry keeps the two newest manifests and
    the producer drops its chunks of the others (gc notice)."""
    from ray_tpu_torch import weights as wts

    pub = wts.WeightPublisher("gc-test")
    for step in range(1, 5):
        pub.publish(_tree(seed=step), step=step)
    c = _conductor()
    rec = c.call("get_weight_versions", timeout=10.0)["names"]["gc-test"]
    assert rec["latest"] == 4
    assert [v["version"] for v in rec["versions"]] == [3, 4]
    assert c.call("weights_get_manifest", "gc-test", 1,
                  timeout=10.0) is None
    _wait_until(lambda: pub.held_versions() == [3, 4],
                msg=lambda: pub.held_versions())
    sub = wts.WeightSubscriber("gc-test")
    _raises(KeyError, sub.fetch, version=1, like=None)
    assert c.call("weights_gc", "gc-test", 1, timeout=10.0) == 1
    listing = c.call("get_weight_versions", timeout=10.0)
    assert [v["version"] for v in
            listing["names"]["gc-test"]["versions"]] == [4]
    pub.close()
    sub.close()


class HalfProducer:
    """Publishes host 0's fragment of a 2-host publish and holds it."""

    def publish_fragment(self):
        from ray_tpu_torch import weights as wts

        pub = wts.WeightPublisher("torn", host_rank=0, num_hosts=2)
        pub.publish({"w": np.ones((8, 8), np.float32)}, step=1)
        self._pub = pub  # its refs live until the kill
        return True


def weights_interrupted_publish_never_visible_and_reaped():
    """The producer dies mid-publish (host 0 of 2 committed): the version
    is never visible and the reaper drops it."""
    import torch

    from ray_tpu_torch import weights as wts

    c = _conductor()
    prod = rt.remote(HalfProducer).remote()
    assert rt.get(prod.publish_fragment.remote(), timeout=60.0)
    sub = wts.WeightSubscriber("torn")
    assert sub.latest_version() is None
    rt.kill(prod)
    assert c.call("weights_reap", 0.0, timeout=10.0) == 1
    listing = c.call("get_weight_versions", timeout=10.0)
    assert "torn" not in listing["names"]
    assert listing["pending"] == []
    kinds = [e["kind"] for e in c.call("get_weight_events", 100,
                                       timeout=10.0)
             if e.get("name") == "torn"]
    assert "reap" in kinds and "publish" not in kinds
    wts.publish({"w": torch.zeros(8, 8)}, name="torn", step=2)
    assert sub.wait_for_version(2, timeout=10.0) == 2
    sub.close()


def weights_gang_resize_supersedes_stale_pending():
    """A pending entry of the OLD gang size is superseded by the re-formed
    gang's publish of the same step, and the supersede frees exactly the
    old fragments' chunks."""
    import torch

    from ray_tpu_torch import weights as wts

    a1 = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    a2 = a1 * 2
    old = wts.WeightPublisher("resize", host_rank=0, num_hosts=2)
    old.publish({"w": a1}, step=1)
    assert old.held_versions() == [1]
    new = wts.WeightPublisher("resize", host_rank=0, num_hosts=1)
    assert new.publish({"w": a2}, step=1) == 1
    sub = wts.WeightSubscriber("resize")
    np.testing.assert_array_equal(sub.fetch()["w"], a2.numpy())
    _wait_until(lambda: not old.held_versions(),
                msg=lambda: old.held_versions())
    assert new.held_versions() == [1]
    np.testing.assert_array_equal(sub.fetch()["w"], a2.numpy())
    for p in (old, new):
        p.close()
    sub.close()


def weights_rollback_republish_served_not_gcd():
    """A restarted gang republishes LOWER versions: latest follows commit
    recency, and GC drops the oldest-committed version."""
    import torch

    from ray_tpu_torch import weights as wts

    def tree(x):
        return {"w": torch.full((8, 8), x)}

    pub = wts.WeightPublisher("rollback")
    pub.publish(tree(5.0), step=5)
    pub.publish(tree(6.0), step=6)
    pub.publish(tree(2.0), step=2)
    c = _conductor()
    assert c.call("weights_latest_version", "rollback", timeout=10.0) == 2
    rec = c.call("get_weight_versions", timeout=10.0)["names"]["rollback"]
    assert rec["latest"] == 2
    assert sorted(v["version"] for v in rec["versions"]) == [2, 6]
    sub = wts.WeightSubscriber("rollback")
    np.testing.assert_array_equal(sub.fetch()["w"],
                                  np.full((8, 8), 2.0, np.float32))
    sub.close()
    pub.close()


def weights_duplicate_version_rejected():
    import torch

    from ray_tpu_torch import weights as wts

    tree = {"w": torch.ones(8, 8)}
    wts.publish(tree, name="dup", step=1)
    e = _raises(ValueError, wts.publish, tree, name="dup", step=1)
    assert "already committed" in str(e)
    # only the duplicate's refs were dropped: version 1 still fetches
    sub = wts.WeightSubscriber("dup")
    np.testing.assert_array_equal(sub.fetch(version=1, like=None)["w"],
                                  np.ones((8, 8), np.float32))
    sub.close()
    assert wts.publish(tree, name="dup") == 2


def _no_step_fn(cfg):
    import torch

    from ray_tpu_torch.train import report

    report({"loss": 1.0}, publish_weights={"w": torch.ones(8, 8)},
           weights_name="mono")


def _replay_fn(cfg):
    import torch

    from ray_tpu_torch.train import report

    tree = {"w": torch.ones(8, 8)}
    report({"step": 2}, publish_weights=tree, weights_name="mono")
    report({"step": 3}, publish_weights=tree, weights_name="mono")


def weights_report_publish_versions_survive_restart():
    """Without a step metric the registry assigns latest + 1 (the report
    count restarts with each attempt); a replayed committed step is a
    no-op, never an error."""
    from ray_tpu_torch.train import RunConfig, TorchTrainer

    tmp = tempfile.mkdtemp(prefix="mono-")
    rc = RunConfig(name="mono-run", storage_path=tmp)
    TorchTrainer(_no_step_fn, run_config=rc).fit()
    TorchTrainer(_no_step_fn, run_config=rc).fit()
    c = _conductor()
    assert c.call("get_weight_versions",
                  timeout=10.0)["names"]["mono"]["latest"] == 2
    result = TorchTrainer(_replay_fn, run_config=rc).fit()
    assert result.error is None, result.error
    assert c.call("get_weight_versions",
                  timeout=10.0)["names"]["mono"]["latest"] == 3


class LM:
    """A serving actor holding a continuous-batching engine on GPT-2 tiny
    (fp32, CPU), synced to the weight set "lm" (the JAX test's
    @serve.deployment)."""

    def __init__(self):
        from ray_tpu_torch import weights as wts
        from ray_tpu_torch.models.engine import ContinuousBatchingEngine

        self.cfg, self.template = _tiny_gpt2(seed=0)
        self.sub = wts.WeightSubscriber("lm")
        params = self.sub.fetch(version=1, like=self.template)
        self.engine = ContinuousBatchingEngine(params, self.cfg,
                                               max_batch=4,
                                               params_version=1)
        self.sync = wts.WeightSync(self.engine, "lm",
                                   template=self.template,
                                   consumer="replica-0",
                                   subscriber=self.sub)

    def generate(self, prompt, n):
        return self.engine.generate(list(prompt), int(n))

    def fresh_generate(self, prompt, n):
        """A fresh engine from the latest version's weights: the
        bit-identity oracle."""
        from ray_tpu_torch import weights as wts
        from ray_tpu_torch.models.engine import ContinuousBatchingEngine

        sub = wts.WeightSubscriber("lm")
        eng = ContinuousBatchingEngine(sub.fetch(like=self.template),
                                       self.cfg, max_batch=2)
        try:
            return eng.generate(list(prompt), int(n))
        finally:
            eng.stop()
            sub.close()

    def status(self):
        return self.sync.status()

    def stop(self):
        self.sync.stop()
        self.engine.stop()
        return True


def _lm_train_fn(cfg):
    from ray_tpu_torch.train import report

    _, params = _tiny_gpt2(seed=42)
    report({"step": 1}, publish_weights=params, weights_name="lm")


def weights_train_publish_serve_hotswap_e2e():
    """The trainer publishes at step 1; a serving actor's engine
    hot-swaps to step 2 between decode ticks: the request in flight
    completes, later streams equal a fresh engine's from the same
    weights, and the registry, the sync's status and the timeline agree.
    (The JAX test's sharded layouts are the gang check's; its CLI,
    dashboard and Prometheus surfaces wait for their port.)"""
    from ray_tpu_torch import weights as wts
    from ray_tpu_torch.observability.timeline import merged_timeline
    from ray_tpu_torch.train import RunConfig, TorchTrainer
    from ray_tpu_torch.tree import tree_map
    from ray_tpu_torch.util import state

    TorchTrainer(_lm_train_fn, run_config=RunConfig(
        name="lm-train", storage_path=tempfile.mkdtemp())).fit()
    assert state.weight_versions("lm")["names"]["lm"]["latest"] == 1
    h = rt.remote(max_concurrency=4)(LM).remote()
    try:
        pre = rt.get(h.generate.remote([1, 2, 3], 8), timeout=120.0)
        assert len(pre) == 8
        long_ref = h.generate.remote([7, 8], 90)
        time.sleep(0.1)
        _, params2 = _tiny_gpt2(seed=42)
        assert wts.publish(tree_map(lambda p: p * 1.1, params2),
                           name="lm", step=2) == 2
        st = {}

        def served():
            st.update(rt.get(h.status.remote(), timeout=60.0))
            return st["serving_version"] == 2

        _wait_until(served, timeout=60.0, msg=lambda: st)
        assert len(rt.get(long_ref, timeout=120.0)) == 90
        assert st["swap_count"] >= 1
        post = rt.get(h.generate.remote([4, 5, 6], 10), timeout=120.0)
        fresh = rt.get(h.fresh_generate.remote([4, 5, 6], 10),
                       timeout=120.0)
        assert post == fresh, (post, fresh)
        assert st["fetched_bytes"] > 0
        assert state.weight_versions()["names"]["lm"]["latest"] == 2
        assert st["latest_version"] == 2
        assert st["staleness_versions"] == 0
        kinds = {e["tid"] for e in merged_timeline()
                 if e.get("cat") == "weights"}
        assert {"publish", "fetch", "swap"} <= kinds, kinds
        assert rt.get(h.stop.remote(), timeout=60.0)
    finally:
        rt.kill(h)


# ------------------------------------------------ the port's own checks

def port_weights_bf16_delta_and_hashes():
    """bf16 and fp32 tensor leaves round-trip through the chunk store (bf16
    as its bits); a delta publish ships only the changed leaf and its
    manifest stays whole; each fetched leaf hashes as the published one."""
    import torch

    from ray_tpu_torch import weights as wts

    tree = {"a": torch.randn(32, 16).to(torch.bfloat16),
            "b": torch.randn(8), "c": torch.tensor(3, dtype=torch.int64)}
    pub = wts.WeightPublisher("bf16")
    assert pub.publish(tree, step=1, delta=True) == 1
    changed = dict(tree, b=tree["b"] + 1)
    assert pub.publish(changed, step=2, delta=True) == 2
    m = _conductor().call("weights_get_manifest", "bf16", 2, timeout=10.0)
    assert m["delta"] and m["base_version"] == 1
    assert m["changed_leaves"] == [1]  # JAX's order: a, b, c
    assert m["leaves"][0]["dtype"] == "bfloat16"
    sub = wts.WeightSubscriber("bf16")
    plain = sub.fetch()
    assert plain["a"].dtype == torch.bfloat16
    assert torch.equal(plain["a"], tree["a"])
    got = sub.fetch(like={k: torch.zeros_like(v)
                          for k, v in changed.items()})
    for k in changed:
        assert torch.equal(got[k], changed[k]), k
    assert wts.leaf_content_hashes(got) == wts.leaf_content_hashes(changed)
    assert sub.last_stats.delta and sub.last_stats.changed_leaves == [1]
    sub.close()
    pub.close()


def port_weights_gc_frees_chunks():
    """A GC'd version's chunks leave the producer's store: the publisher
    drops its refs on the notice and the refcount layer frees them."""
    from ray_tpu_torch import weights as wts
    from ray_tpu_torch._private import refcount

    store = _worker().store
    pub = wts.WeightPublisher("free")
    pub.publish(_tree(seed=1), step=1)
    first = set(pub.held_object_ids())
    assert first and all(store.contains(o) for o in first)
    pub.publish(_tree(seed=2), step=2)
    pub.publish(_tree(seed=3), step=3)  # weights_keep 2: v1 goes

    def gone():
        refcount.tracker.flush()
        return not any(store.contains(o) for o in first)

    _wait_until(gone, msg=lambda: [o for o in first if store.contains(o)])
    assert pub.held_versions() == [2, 3]
    pub.close()


def port_weights_sync_streams():
    """WeightSync swaps an engine from GPT-2 tiny (seed 0) to the same
    weights times 1.25, published by the driver; returns the greedy
    streams after the swap for the JAX engine's comparison."""
    from ray_tpu_torch import weights as wts
    from ray_tpu_torch.models.engine import ContinuousBatchingEngine
    from ray_tpu_torch.tree import tree_map

    cfg, params_a = _tiny_gpt2(seed=0)
    params_b = tree_map(lambda p: p * 1.25, params_a)
    eng = ContinuousBatchingEngine(params_a, cfg, max_batch=2,
                                   params_version=1)
    sync = wts.WeightSync(eng, "swap", poll_interval_s=0.05)
    try:
        wts.publish(params_b, name="swap", step=2)
        assert sync.wait_for_swap(2, timeout=60.0) == 2
        streams = [eng.generate(p, 8) for p in ([5, 6], [9, 9, 9, 9])]
        assert eng.swap_count == 1 and sync.swap_count == 1
        assert sync.status()["staleness_versions"] == 0
    finally:
        sync.stop()
        eng.stop()
    return {"streams": streams}


# -------------------------------------- tests/test_lora.py, fabric path

def lora_fabric_source_pages_and_hot_swaps():
    """A TenantLoraTrainer publishes adapter deltas; a pool over
    FabricAdapterSource (build_pool(lora=True)) pages the newest version
    in, streams as a pool over a LocalAdapterSource of the trainer's
    adapter, and hot-swaps on a third publish's notice."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.engine import ContinuousBatchingEngine
    from ray_tpu_torch.online import TenantLoraTrainer
    from ray_tpu_torch.serve import lora

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = llama.llama_init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    trainer = TenantLoraTrainer(params, cfg, "fabt", rank=2,
                                publish_every=1, learning_rate=1e-2, seed=0)
    rng = np.random.default_rng(0)
    batch = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    res = trainer.fit([batch, batch], num_steps=2)
    assert res["published_versions"] == [1, 2], res
    assert len(res["losses"]) == 2
    pool = lora.build_pool(cfg, True, slots=2, device="cpu")
    assert isinstance(pool.source, lora.FabricAdapterSource)
    row = pool.acquire("fabt")
    assert row != 0
    assert pool.resident_version("fabt") == 2
    assert pool.stats()["page_in_bytes"] > 0
    pool.release("fabt")
    local = lora.build_pool(cfg, {"fabt": trainer.adapter()}, slots=2,
                            device="cpu")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    streams = []
    for p in (pool, local):
        eng = ContinuousBatchingEngine(params, cfg, max_batch=2,
                                       lora_pool=p)
        try:
            streams.append(eng.generate(prompt, 8, adapter_id="fabt"))
        finally:
            eng.stop()
    assert streams[0] == streams[1], streams
    swaps = pool.stats()["swaps"]
    trainer.step(batch)
    assert trainer.publish() == 3
    _wait_until(lambda: pool.source.dirty("fabt"), 10.0,
                "the third publish's notice never landed")
    pool.acquire("fabt")
    pool.release("fabt")
    assert pool.resident_version("fabt") == 3
    assert pool.stats()["swaps"] == swaps + 1
    pool.source.close()
    return {"losses": trainer.losses}


# ---------------------------------------------- tests/test_train_gang.py

def _gang_train_fn(cfg):
    # no setup call here: the trainer formed the group already
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import get_context, report

    ctx = get_context()
    assert dist.is_initialized(), "gang not formed"
    assert dist.get_world_size() == ctx.get_world_size()
    x = torch.tensor([float(ctx.get_world_rank() + 1)])
    dist.all_reduce(x)
    report({"rank": ctx.get_world_rank(), "total": float(x),
            "procs": dist.get_world_size(),
            "backend": dist.get_backend(), "device": ctx.device})


def gang_workers_mode_forms_gang_and_aggregates():
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    result = TorchTrainer(
        _gang_train_fn,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=tempfile.mkdtemp()),
        mode="workers").fit()
    assert result.error is None, result.error
    assert result.metrics["procs"] == 2
    assert result.metrics["total"] == 1.0 + 2.0
    assert {m["rank"] for m in result.metrics["rank_metrics"]} == {0, 1}
    # use_gpu=False: no GPU in the bundle, so the rank computes on the
    # CPU over gloo
    assert result.metrics["backend"] == "gloo"
    assert result.metrics["device"] == "cpu"


def _opt_out_fn(cfg):
    from ray_tpu_torch.parallel.distributed import \
        is_torch_distributed_initialized
    from ray_tpu_torch.train import report

    report({"initialized": is_torch_distributed_initialized()})


def gang_workers_mode_opt_out():
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    result = TorchTrainer(
        _opt_out_fn,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     setup_torch_distributed=False),
        run_config=RunConfig(storage_path=tempfile.mkdtemp()),
        mode="workers").fit()
    assert result.error is None, result.error
    assert result.metrics["initialized"] is False


# ----------------------------------------------- tests/test_resilience.py

def expected_losses(n_steps: int):
    """The deterministic SGD-on-sum(w^2) trajectory of sgd_train_fn."""
    w, out = np.full(4, 5.0), []
    for _ in range(n_steps):
        out.append(float((w ** 2).sum()))
        w = w - 0.2 * w
    return out


def _ready_dir() -> str:
    from ray_tpu_torch.train import get_context

    ctx = get_context()
    return os.path.join(ctx.trial_dir, f"ready-{ctx.attempt}")


def _mark_ready(cfg) -> None:
    """A rank's train_fn has started, so its session has subscribed to
    the preemption notices (the trainer subscribes before train_fn)."""
    from ray_tpu_torch.train import get_context

    if cfg.get("notice_after") and get_context().attempt == 0:
        os.makedirs(_ready_dir(), exist_ok=True)
        open(os.path.join(_ready_dir(),
                          f"rank{get_context().get_world_rank()}"),
             "w").close()


def _before_report(cfg, step: int) -> None:
    """Before the report of `step`: on rank 0, which fires the scripted
    preemption in that report, wait (bounded) until every rank has
    started, so that every rank gets the notice; at the step a chaos
    kill is scripted at, wait (bounded) until a grace checkpoint is in
    the trial's pending/, so the restart resumes from it whatever the
    machine's load."""
    from ray_tpu_torch.train import get_context

    ctx = get_context()
    if cfg.get("notice_after") == step and ctx.attempt == 0 \
            and ctx.get_world_rank() == 0:
        _wait_until(lambda: len(os.listdir(_ready_dir()))
                    == ctx.get_world_size(), timeout=30.0,
                    msg="a rank never started")
    if cfg.get("kill_at") == step:
        pending = os.path.join(ctx.trial_dir, "pending")
        _wait_until(lambda: os.path.isdir(pending) and os.listdir(pending),
                    timeout=30.0, msg="no grace checkpoint in pending/")


def _await_notice(cfg, step: int) -> None:
    """After the report of the step that fires the preemption, every
    rank waits (bounded) for the notice: each then takes its grace
    checkpoint at the next step, whatever the machine's load, where the
    JAX test sleeps between steps. (A rank racing ahead would otherwise
    see the notice late and checkpoint past the kill's step.)"""
    from ray_tpu_torch.train import get_context, preemption_requested

    if cfg.get("notice_after") == step and get_context().attempt == 0:
        _wait_until(lambda: preemption_requested() is not None,
                    timeout=20.0, msg="no preemption notice")


def sgd_train_fn(cfg):
    """tests/test_resilience.py `_sgd_train_fn`: SGD on sum(w^2), a
    checkpoint every step when asked and a grace checkpoint at the first
    step after a preemption notice."""
    import numpy as _np

    from ray_tpu_torch.train import (Checkpoint, get_checkpoint,
                                     get_context, preemption_requested,
                                     report)
    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree

    ctx = get_context()
    step, w = 0, _np.full(4, 5.0)
    ck = get_checkpoint()
    if ck is not None:
        st = load_pytree(ck.path)
        step, w = int(st["step"]), _np.asarray(st["w"])
    graced = False
    _mark_ready(cfg)
    while step < int(cfg["n_steps"]):
        step += 1
        loss = float((w ** 2).sum())
        w = w - 0.2 * w
        ckpt = None
        want_ckpt = bool(cfg.get("checkpoint_every_step"))
        if preemption_requested() is not None and not graced:
            graced, want_ckpt = True, True
        if want_ckpt:
            d = tempfile.mkdtemp(prefix="sgd_ckpt_")
            save_pytree({"step": _np.int64(step), "w": w}, d)
            ckpt = Checkpoint(d)
        _before_report(cfg, step)
        report({"step": step, "loss": loss,
                "world": ctx.get_world_size()}, checkpoint=ckpt)
        _await_notice(cfg, step)


def async_grace_train_fn(cfg):
    """tests/test_resilience.py `_async_grace_train_fn`: the grace
    checkpoint through an AsyncCheckpointer whose write delay far exceeds
    the bound, so only the expedite path commits it in time."""
    import numpy as _np

    from ray_tpu_torch.train import (get_checkpoint, get_context,
                                     preemption_requested, report)
    from ray_tpu_torch.train import async_checkpoint as _ac

    ctx = get_context()
    ckpter = _ac.AsyncCheckpointer()
    ckpter._test_write_delay = float(cfg.get("write_delay", 0.0))
    step, w = 0, _np.full(4, 5.0)
    ck = get_checkpoint()
    if ck is not None:
        st = _ac.restore(ck.path)
        step, w = int(st["step"]), _np.asarray(st["w"])
    graced = False
    _mark_ready(cfg)
    while step < int(cfg["n_steps"]):
        step += 1
        loss = float((w ** 2).sum())
        w = w - 0.2 * w
        ckpt = None
        if preemption_requested() is not None and not graced:
            graced = True
            d = tempfile.mkdtemp(prefix="agrace_")
            ckpt = ckpter.save(d, {"step": _np.int64(step), "w": w})
        _before_report(cfg, step)
        report({"step": step, "loss": loss,
                "world": ctx.get_world_size()}, checkpoint=ckpt)
        _await_notice(cfg, step)


def _check_trajectory(result, lo: int, hi: int) -> None:
    expected = expected_losses(N_STEPS)
    assert result.metrics["step"] == N_STEPS
    for m in result.metrics_history:
        assert abs(m["loss"] - expected[m["step"] - 1]) \
            <= 1e-12 * expected[m["step"] - 1], m
    first = result.metrics_history[0]["step"]
    assert lo < first <= hi, first


def gang_async_grace_checkpoint_commits_within_window():
    """An in-flight async save at preemption time is expedited and
    persisted into pending/ before the chaos kill lands, so the restart
    resumes from the grace checkpoint within the bound."""
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)
    from ray_tpu_torch.util import state

    plan = json.dumps([
        {"action": "preempt", "node": "head", "grace_s": 15.0,
         "at_step": 2},
        {"action": "kill", "rank": 1, "at_step": 6}])
    t0 = time.monotonic()
    result = TorchTrainer(
        async_grace_train_fn,
        train_loop_config={"n_steps": N_STEPS, "write_delay": 60.0,
                           "notice_after": 2, "kill_at": 6},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     setup_torch_distributed=False),
        run_config=RunConfig(name="async-grace",
                             storage_path=tempfile.mkdtemp(),
                             failure_config=FailureConfig(max_failures=2)),
        mode="workers", chaos_plan=plan, restart_backoff_base_s=0.1,
        restart_backoff_max_s=0.2).fit()
    elapsed = time.monotonic() - t0
    assert result.error is None, result.error
    assert elapsed < 45.0, elapsed  # the expedite cut the 60 s delay
    _check_trajectory(result, 3, 7)
    st = state.resilience_status()
    assert st["counters"].get("grace_checkpoint", 0) >= 1, st["counters"]


def gang_preempt_quarantine_elastic_restart_scenario():
    """Preempt the gang's host with a grace window mid-run -> grace
    checkpoint -> the host dies under rank 1 and is quarantined -> the
    gang restarts without it, re-formed smaller -> the losses follow the
    uninterrupted trajectory; every event is counted and on the
    timeline."""
    from ray_tpu_torch.observability.timeline import merged_timeline
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)
    from ray_tpu_torch.util import state

    c = _conductor()
    c.call("register_node", "flaky-host", {"CPU": 4.0}, None, timeout=10.0)
    plan = json.dumps([
        {"action": "preempt", "node": "flaky-host", "grace_s": 10.0,
         "at_step": 2},
        {"action": "kill", "rank": 1, "at_step": 5}])
    # 3 workers need 3 CPUs: STRICT_PACK lands only on flaky-host
    trainer = TorchTrainer(
        sgd_train_fn,
        train_loop_config={"n_steps": N_STEPS, "notice_after": 2,
                           "kill_at": 5},
        scaling_config=ScalingConfig(num_workers=3, min_workers=2,
                                     use_gpu=False,
                                     setup_torch_distributed=False),
        run_config=RunConfig(name="chaos-accept",
                             storage_path=tempfile.mkdtemp(),
                             failure_config=FailureConfig(max_failures=2)),
        mode="workers", chaos_plan=plan, restart_backoff_base_s=0.3,
        restart_backoff_max_s=0.6)
    result = trainer.fit()
    assert result.error is None, result.error
    _check_trajectory(result, 3, 6)
    # elastic re-form: without flaky-host the capacity is the 2-CPU head
    assert result.metrics["world"] == 2
    assert trainer.scaling_config.num_workers == 2
    st = state.resilience_status()
    assert "flaky-host" in st["excluded"]
    dom = st["domains"]["flaky-host"]
    assert dom["quarantined"] and dom["failures"] >= 1
    for kind in ("preemption", "worker_death", "quarantine", "restart",
                 "grace_checkpoint", "elastic_reform", "recovery",
                 "chaos"):
        assert st["counters"].get(kind, 0) >= 1, (kind, st["counters"])
    assert st["last_ttr_s"] is not None and st["last_ttr_s"] > 0
    kinds = {e["tid"] for e in merged_timeline()
             if e.get("cat") == "resilience"}
    assert {"preemption", "restart", "quarantine",
            "grace_checkpoint"} <= kinds, kinds


def _collective_then_die_fn(cfg):
    """Rank 1 exits while rank 0 waits inside an all_reduce that can
    never complete."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import get_context

    ctx = get_context()
    if ctx.get_world_rank() == 1:
        time.sleep(0.5)
        os._exit(137)
    x = torch.ones(4)
    dist.all_reduce(x)  # blocks in gloo: no Python-level cancel reaches it
    raise AssertionError("the all_reduce completed without rank 1")


def port_gang_dead_rank_in_collective():
    """A rank that dies inside a collective: the fit fails fast (far
    before the group's 120 s timeout) with an error, and every rank's
    process is gone."""
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    t0 = time.monotonic()
    result = TorchTrainer(
        _collective_then_die_fn,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=tempfile.mkdtemp()),
        mode="workers").fit()
    elapsed = time.monotonic() - t0
    assert isinstance(result.error, exc.RayTpuError), repr(result.error)
    assert elapsed < 30.0, elapsed
    c = _conductor()
    _wait_until(lambda: all(a["state"] == "DEAD" for a in
                            c.call("list_actors", timeout=10.0)),
                msg=lambda: c.call("list_actors", timeout=10.0))


# --------------------------------------- GPT-2 tiny on a gang, with chaos

GANG_STEPS = 4
GANG_BATCH = (4, 32)


def gang_batch(cfg, step: int):
    """The global batch of training step `step` (1-based), from a seed."""
    import torch

    gen = torch.Generator().manual_seed(100 + step)
    seq = torch.randint(0, cfg.vocab_size,
                        (GANG_BATCH[0], GANG_BATCH[1] + 1), generator=gen)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def _local_copy(t):
    """A replicated DTensor's (or a tensor's) values, detached."""
    return (t.to_local() if hasattr(t, "to_local") else t).detach().clone()


def gpt2_gang_train_fn(cfg):
    """GPT-2 tiny fp32 under the mesh TrainStep on a (dp,) mesh of the
    gang's ranks (params replicated, the batch split by rows), adamw(1e-3),
    GANG_STEPS steps. Rank 0 reports a checkpoint of the whole state at
    every step; a resumed attempt loads it on every rank."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.mesh import MeshConfig, P, make_mesh
    from ray_tpu_torch.train import (Checkpoint, get_checkpoint,
                                     get_context, report)
    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import TrainStep
    from ray_tpu_torch.tree import tree_leaves, tree_map

    import torch

    torch.set_num_threads(1)  # ranks share the host's cores
    ctx = get_context()
    mcfg, params = _tiny_gpt2(seed=cfg.get("seed", 7))
    mesh = make_mesh(MeshConfig(dp=ctx.get_world_size()), device="cpu")
    specs = tree_map(lambda _: P(), params)
    step = TrainStep(lambda p, b: gpt2.gpt2_loss(p, b["tokens"],
                                                 b["targets"], mcfg),
                     adamw(1e-3), device="cpu", mesh=mesh,
                     param_specs=specs)
    ck = get_checkpoint()
    saved = load_pytree(ck.path) if ck is not None else None
    state = step.init_state(saved["params"] if saved else params)
    if saved is not None:
        for name in ("mu", "nu"):
            for dst, src in zip(tree_leaves(state["opt_state"][name]),
                                tree_leaves(saved[name])):
                dst.to_local().copy_(src)
        state["opt_state"]["count"] = int(saved["count"])
        state["step"] = int(saved["step"])
    while state["step"] < GANG_STEPS:
        state, m = step(state, gang_batch(mcfg, state["step"] + 1))
        metrics = {"step": state["step"], "loss": float(m["loss"])}
        if ctx.get_world_rank() != 0:
            # rank 0's checkpoint of this step is in pending/ before any
            # other rank reports it (where a chaos kill may fire)
            dist.barrier()
            report(metrics)
            continue
        # dp only: rank 0 holds the whole (replicated) state
        d = tempfile.mkdtemp(prefix="gang_gpt2_")
        save_pytree({"params": tree_map(_local_copy, state["params"]),
                     "mu": tree_map(_local_copy, state["opt_state"]["mu"]),
                     "nu": tree_map(_local_copy, state["opt_state"]["nu"]),
                     "count": np.int64(state["opt_state"]["count"]),
                     "step": np.int64(state["step"])}, d)
        report(metrics, checkpoint=Checkpoint(d))
        dist.barrier()


def gpt2_reference_losses(seed: int = 7):
    """The one-process step's losses on the same weights and batches."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import TrainStep

    mcfg, params = _tiny_gpt2(seed=seed)
    step = TrainStep(lambda p, b: gpt2.gpt2_loss(p, b["tokens"],
                                                 b["targets"], mcfg),
                     adamw(1e-3), device="cpu")
    state = step.init_state(params)
    losses = []
    for i in range(GANG_STEPS):
        state, m = step(state, gang_batch(mcfg, i + 1))
        losses.append(float(m["loss"]))
    return losses


def gpt2_gang_fit(chaos_plan=None, num_workers: int = 2) -> dict:
    """One workers-mode fit of gpt2_gang_train_fn; its losses by step."""
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    result = TorchTrainer(
        gpt2_gang_train_fn,
        scaling_config=ScalingConfig(num_workers=num_workers,
                                     use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="gang-gpt2",
                             storage_path=tempfile.mkdtemp(),
                             failure_config=FailureConfig(max_failures=1)),
        mode="workers", chaos_plan=chaos_plan,
        restart_backoff_base_s=0.1, restart_backoff_max_s=0.2).fit()
    if result.error is not None:
        raise result.error
    return {"steps": [m["step"] for m in result.metrics_history],
            "losses": [m["loss"] for m in result.metrics_history],
            "rank_losses": [[r["loss"] for r in m["rank_metrics"]]
                            for m in result.metrics_history]}


GANG_LOSS_TOL = 1e-5


def port_gang_gpt2_losses_and_chaos_restart():
    """GPT-2 tiny on a 2-rank gloo gang: each step's loss is the
    one-process step's within 1e-5 (fp32: the dp reduction reorders one
    sum), equal on both ranks; killing rank 1 at step 2 restarts from
    pending/ at step 3 and ends on the uninterrupted run's last loss."""
    ref = gpt2_reference_losses()
    full = gpt2_gang_fit()
    assert full["steps"] == list(range(1, GANG_STEPS + 1)), full
    for got, want, ranks in zip(full["losses"], ref, full["rank_losses"]):
        assert abs(got - want) <= GANG_LOSS_TOL, (got, want)
        assert len(set(ranks)) == 1, ranks
    plan = json.dumps([{"action": "kill", "rank": 1, "at_step": 2}])
    chaos = gpt2_gang_fit(plan)
    assert chaos["steps"] == list(range(3, GANG_STEPS + 1)), chaos
    assert chaos["losses"][-1] == full["losses"][-1], (chaos, full)
    return {"reference": ref, "gang": full["losses"],
            "restarted": chaos["losses"]}
