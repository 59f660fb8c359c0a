"""The live weight fabric of the port (ray_tpu_torch.weights, util.chunks,
the conductor's version registry) against the JAX package's.

Twins of all 11 cases of tests/test_weights.py. Those that need a cluster
are checks of `ray_tpu_torch/_private/fabric_checks.py`, each run in a
driver process of its own (`_private/isolated.run_checks`, one cluster a
check, `weights_keep` 2 as the JAX fixture sets it, hard timeout 300 s):
no cluster, arena or worker lives in the pytest process. The sharded
layouts (a (dp, fsdp) row split published, a (tp,) column split fetched)
run on a 4-rank gloo gang whose ranks are drivers of the check's cluster
(`_private/weights_gang_checks.py`); the e2e case serves from a plain actor that
holds the engine, in place of `@serve.deployment`. The engine's hot swap
runs here, beside the JAX engine's.

Parity with the JAX package on the same inputs: `util.chunks`
(`ensure_chunkable`, `put_tree` / `fetch_tree` through an in-memory
store), the registry's latest and kept versions after one sequence of
publish, GC and reap calls on both packages' conductor handlers (no
server, as the JAX package's own policy tests build one), per-leaf
content hashes, and `WeightSync`'s swapped engine against JAX's
`ContinuousBatchingEngine` from the same weights: greedy streams equal.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu._private import object_store as jstore
from ray_tpu._private.conductor import ConductorHandler as JHandler
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.util import chunks as jchunks
from ray_tpu.weights import publisher as jpub
from ray_tpu_torch._private import fabric_checks, isolated
from ray_tpu_torch._private import object_store as tstore
from ray_tpu_torch._private.conductor import ConductorHandler as THandler
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.tree import tree_map
from ray_tpu_torch.util import chunks as tchunks
from ray_tpu_torch.weights import publisher as tpub

WEIGHTS = {"num_cpus": 4, "_system_config": fabric_checks.WEIGHTS_CONFIG}
CHECKS = {name: WEIGHTS for name in (
    "weights_publish_fetch_reshard_roundtrip",
    "weights_fetch_without_template_returns_numpy",
    "weights_multi_host_fragments_merge",
    "weights_version_gc_keeps_exactly_k",
    "weights_interrupted_publish_never_visible_and_reaped",
    "weights_gang_resize_supersedes_stale_pending",
    "weights_rollback_republish_served_not_gcd",
    "weights_duplicate_version_rejected",
    "weights_report_publish_versions_survive_restart",
    "weights_train_publish_serve_hotswap_e2e",
    "port_weights_bf16_delta_and_hashes",
    "port_weights_gc_frees_chunks",
    "port_weights_sync_streams")}

JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), num_heads=2,
                           dtype=jnp.float32)


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_weights(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_sync_streams_match_jax_engine(outcomes):
    """The engine WeightSync swapped to GPT-2 tiny x 1.25 streams as the
    JAX engine started from the same weights."""
    ok, text = outcomes["port_weights_sync_streams"]
    assert ok, text
    _, params = fabric_checks._tiny_gpt2(seed=0)
    jp = jax.tree.map(jnp.asarray,
                      tree_map(lambda p: (p * 1.25).numpy(), params))
    jeng = JEngine(jp, JCFG, max_batch=2, prefix_cache=False)
    try:
        want = [[int(t) for t in jeng.generate(p, 8)]
                for p in ([5, 6], [9, 9, 9, 9])]
    finally:
        jeng.stop()
    assert json.loads(text)["streams"] == want


# ------------------------------------------------------------ util.chunks

class _Store:
    def __init__(self):
        self.objects = {}

    def contains(self, oid):
        return oid in self.objects


class _Worker:
    """put / get / store / address of a worker, in memory."""

    def __init__(self, ref_cls):
        self.ref_cls = ref_cls
        self.store = _Store()
        self.address = ("127.0.0.1", 1)

    def put(self, value):
        ref = self.ref_cls(locator=self.address, owner=self.address)
        self.store.objects[ref.id] = np.array(value, copy=True)
        return ref

    def get(self, ref, timeout=None):
        return self.store.objects[ref.id]


def _numpy_tree():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((6, 9)).astype(np.float32)
    return {"w": base, "t": base.T, "s": np.float32(2.5),
            "i": np.arange(7, dtype=np.int64),
            "nested": [rng.standard_normal(3), np.int32(4)]}


@pytest.mark.parametrize("name", ["zero_d", "transposed", "strided",
                                  "contiguous"])
def test_ensure_chunkable_matches_jax(name):
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    arr = {"zero_d": np.float64(1.5), "transposed": base.T,
           "strided": base[:, ::2], "contiguous": base}[name]
    got, want = tchunks.ensure_chunkable(arr), jchunks.ensure_chunkable(arr)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.flags.c_contiguous == want.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_ensure_chunkable_tensors_travel_as_host_bits():
    t = torch.randn(5, 3).to(torch.bfloat16)
    got = tchunks.ensure_chunkable(t)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(
        got, np.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
        .view(np.uint16))
    # the port's checkpoint snapshots hold bf16 as 2-byte records
    assert tchunks.ensure_chunkable(got.view("V2")).dtype == np.uint16
    np.testing.assert_array_equal(tchunks.ensure_chunkable(t.float().T),
                                  t.float().numpy().T)


def test_put_tree_fetch_tree_match_jax():
    tree = _numpy_tree()
    tw, jw = _Worker(tstore.ObjectRef), _Worker(jstore.ObjectRef)
    trefs, tdesc = tchunks.put_tree(tw, tree)
    jrefs, jdesc = jchunks.put_tree(jw, tree)
    keys = ("nbytes", "shape", "dtype")
    assert [{k: e[k] for k in keys} for e in tdesc["leaves"]] == \
        [{k: e[k] for k in keys} for e in jdesc["leaves"]]
    assert tdesc["total_bytes"] == jdesc["total_bytes"]
    got = tchunks.fetch_tree(tw, tdesc)
    want = jchunks.fetch_tree(jw, jdesc)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got["nested"][1].shape == () and got["s"].shape == ()
    # a fetcher pulls each chunk once and accounts for it
    fetcher = tchunks.ChunkFetcher(tw, caller="test")
    for e in tdesc["leaves"] * 2:
        fetcher(e)
    assert fetcher.stats()["chunks_local"] == len(tdesc["leaves"])
    del trefs, jrefs


def test_put_tree_fetch_tree_tensor_leaves():
    tree = {"bf16": torch.randn(4, 4).to(torch.bfloat16),
            "fp32": torch.randn(3), "np": np.ones(2, np.float32)}
    w = _Worker(tstore.ObjectRef)
    refs, desc = tchunks.put_tree(w, tree)
    assert [e["dtype"] for e in desc["leaves"]] == \
        ["bfloat16", "float32", "float32"]
    got = tchunks.fetch_tree(w, desc)
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"], tree["bf16"])
    assert torch.equal(got["fp32"], tree["fp32"])
    assert isinstance(got["np"], np.ndarray)
    del refs


def test_chunk_fetch_retries_and_chaos_delay():
    """Transient pull failures retry `retries` times (the JAX knob's
    default, 2), then raise; the plan's delay_chunk_fetch stretches each
    pull; ObjectLostError-like failures are not retried."""
    w = _Worker(tstore.ObjectRef)
    _, entry = tchunks.put_chunk(w, np.ones(4, np.float32))
    real, calls = w.get, []

    def flaky(ref, timeout=None):
        calls.append(1)
        if len(calls) <= 2:
            raise TimeoutError("slow owner")
        return real(ref, timeout)

    w.get = flaky
    f = tchunks.ChunkFetcher(w)
    np.testing.assert_array_equal(f(entry), np.ones(4, np.float32))
    assert f.fetch_retries == 2 and len(calls) == 3
    calls.clear()
    with pytest.raises(TimeoutError):
        tchunks.ChunkFetcher(w, retries=1)(entry)
    assert len(calls) == 2
    plan = json.dumps([{"action": "delay_chunk_fetch", "ms": 150}])
    w.get = real
    t0 = time.perf_counter()
    tchunks.ChunkFetcher(w, chaos_plan=plan)(entry)
    assert time.perf_counter() - t0 >= 0.15


# ------------------------------------------------- the registry, parity

def _fragment(leaves, host_shards, treedef=True, base=None):
    """A metadata fragment of `leaves` ({i: nbytes}); object ids are
    deterministic names, not store entries."""
    frag = {"n_leaves": len(leaves), "leaves": {
        str(i): {"shape": [n // 4], "dtype": "float32", "hash": None,
                 "shards": [{"object_id": f"{host_shards}-{i}",
                             "locator": ["127.0.0.1", 1], "nbytes": n,
                             "index": [[0, n // 4, 1]]}]}
        for i, n in leaves.items()}}
    if treedef:
        frag["treedef"] = b"structure"
    if base is not None:
        frag["base_version"] = base
    return frag


def _registry_sequence(h) -> dict:
    """One sequence of publishes (full, 2-host, a torn one, a rollback),
    GC and reaps on a conductor handler; returns what the registry holds
    after each phase."""
    seen = {}

    def snap(tag):
        v = h.get_weight_versions()
        seen[tag] = {
            "names": {n: {"latest": r["latest"],
                          "versions": [m["version"] for m in r["versions"]]}
                      for n, r in v["names"].items()},
            "pending": sorted((p["name"], p["version"])
                              for p in v["pending"])}

    for step in range(1, 6):
        h.weights_publish_fragment("a", step, 0, 1,
                                   _fragment({0: 64, 1: 16}, f"a{step}"),
                                   "run", step)
        time.sleep(0.002)
    snap("keep_default")
    h.weights_publish_fragment("b", 1, 0, 2, _fragment({0: 32}, "b1h0"))
    snap("pending")
    h.weights_publish_fragment("b", 1, 1, 2,
                               _fragment({0: 32}, "b1h1", treedef=False))
    snap("joint")
    h.weights_publish_fragment("c", 1, 0, 2, _fragment({0: 8}, "c1"))
    assert h.weights_reap(0.0) == 1
    snap("reaped")
    h.weights_publish_fragment("a", 2, 0, 1, _fragment({0: 64, 1: 16},
                                                       "a2r"))
    snap("rollback")
    dup = h.weights_publish_fragment("a", 2, 0, 1, _fragment({0: 64},
                                                             "a2d"))
    seen["duplicate_error"] = "already committed" in dup.get("error", "")
    gone = h.weights_publish_fragment("a", 9, 0, 1, _fragment(
        {0: 64, 1: 16}, "a9", base=1))
    seen["gone_base_error"] = "delta base" in gone.get("error", "")
    seen["gc_dropped"] = h.weights_gc("a", 1)
    snap("gc")
    seen["latest_b"] = h.weights_latest_version("b")
    seen["has_b1"] = h.weights_has_version("b", 1)
    m = h.weights_get_manifest("b", None)
    seen["b_manifest"] = {k: m[k] for k in ("version", "num_hosts",
                                            "n_leaves", "n_chunks",
                                            "total_bytes")}
    seen["events"] = [(e["kind"], e["name"], e["version"])
                      for e in h.get_weight_events()]
    return seen


def test_registry_matches_jax_conductor(tmp_path):
    jh = JHandler({"CPU": 2.0}, str(tmp_path / "j"))
    th = THandler({"CPU": 2.0}, str(tmp_path / "t"))
    try:
        want = _registry_sequence(jh)
        got = _registry_sequence(th)
    finally:
        jh._stopped = th._stopped = True
    assert got == want
    assert got["keep_default"]["names"]["a"]["versions"] == [3, 4, 5]
    assert got["rollback"]["names"]["a"]["latest"] == 2


def test_registry_survives_conductor_restart(tmp_path):
    """The registry is part of the persisted state: committed manifests
    and pending fragments come back in a conductor started on the same
    session directory."""
    h = THandler({"CPU": 2.0}, str(tmp_path))
    h.weights_publish_fragment("p", 1, 0, 1, _fragment({0: 16}, "p1"))
    h.weights_publish_fragment("q", 3, 0, 2, _fragment({0: 16}, "q3"))
    h._flush_state()
    h._stopped = True
    h2 = THandler({"CPU": 2.0}, str(tmp_path))
    try:
        v = h2.get_weight_versions()
        assert v["names"]["p"]["latest"] == 1
        assert [(p["name"], p["version"]) for p in v["pending"]] == \
            [("q", 3)]
        assert h2.weights_get_manifest("p", 1)["total_bytes"] == 16
    finally:
        h2._stopped = True


# ------------------------------------------------------- content hashes

def test_leaf_content_hashes_match_jax():
    """The delta publication's change detector hashes the same bytes in
    both packages: fp32 and int leaves, a 0-d leaf. (The JAX package's
    cannot hash a bf16 leaf: `memoryview` refuses ml_dtypes' bfloat16,
    "cannot include dtype 'E' in a buffer"; the port hashes its bits.)"""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((8, 5)).astype(np.float32)
    b = np.arange(6, dtype=np.int32)
    jtree = {"a": jnp.asarray(a), "b": jnp.asarray(b),
             "s": jnp.float32(3.0)}
    ttree = {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
             "s": torch.tensor(3.0)}
    assert tpub.leaf_content_hashes(ttree) == jpub.leaf_content_hashes(jtree)
    with pytest.raises(ValueError, match="buffer"):
        jpub.leaf_content_hashes({"c": jnp.zeros(4, jnp.bfloat16)})
    c = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    ttree["c"] = c.to(torch.bfloat16)
    bumped = dict(ttree, b=ttree["b"] + 1,
                  c=(c + 1).to(torch.bfloat16))
    changed = [x != y for x, y in zip(tpub.leaf_content_hashes(ttree),
                                      tpub.leaf_content_hashes(bumped))]
    assert changed == [False, True, True, False]


# ------------------------------------------------------ engine hot swap

def test_engine_hot_swap_between_ticks():
    """tests/test_weights.py's case on the port's engine: update_params
    applies between decode ticks; the request in flight completes; later
    streams equal a fresh engine's from the same weights and the JAX
    engine's; a swap queued after stop() applies at once."""
    cfg, params_a = fabric_checks._tiny_gpt2(seed=0)
    params_b = tree_map(lambda p: p * 1.25, params_a)
    eng = ContinuousBatchingEngine(params_a, cfg, max_batch=2,
                                   params_version=1)
    fresh = ContinuousBatchingEngine(params_b, cfg, max_batch=2,
                                     params_version=2)
    jp = jax.tree.map(jnp.asarray, tree_map(lambda p: p.numpy(), params_b))
    jeng = JEngine(jp, JCFG, max_batch=2, prefix_cache=False)
    try:
        with cf.ThreadPoolExecutor(1) as pool:
            long_fut = pool.submit(eng.generate, [1, 2, 3], 60)
            time.sleep(0.15)
            applied = eng.update_params(params_b, version=2)
            assert applied.wait(timeout=30.0)
            long_toks = long_fut.result(timeout=120)
        assert len(long_toks) == 60
        assert eng.params_version == 2 and eng.swap_count == 1
        for prompt in ([5, 6], [9, 9, 9, 9]):
            got = eng.generate(prompt, 8)
            assert got == fresh.generate(prompt, 8)
            assert got == [int(t) for t in jeng.generate(prompt, 8)]
    finally:
        eng.stop()
        fresh.stop()
        jeng.stop()
    late = eng.update_params(params_a, version=3)
    assert late.wait(timeout=5.0)
    assert eng.params_version == 3
