"""The online learning loop of the port (ray_tpu_torch/online/, the
frozen-leaf Adam of train/optim.py, the conductor's online and autoscale
aggregates) against the JAX package's, on the CPU.

Twins of tests/test_online.py, each cluster case a check of
`_private/online_checks.py` run in a driver process of its own
(`isolated.run_checks`, `weights_keep` 3 as the JAX fixture sets it):
the rollout buffer's backpressure and versions, a sampler in this
process (its rollout held against the JAX engine's greedy stream and
logprobs on the same weights), the online-distillation loop end to end
(2 sampler actors, the learner in the driver; its state-API and timeline
legs, `wpe` frozen across versions), and the weight-fabric cases: delta
publication, delta chains across GC'd bases, a rapid publication cadence
followed within one version, the unreachable-registry flag, prefetch and
delta fetch bytes, the chunk fetcher's shm / rpc accounting, and (here,
no cluster) the leaf reader's shard preference and the content hashes'
change detection. Covered elsewhere as well:
test_leaf_content_hashes_detect_changes' byte-level parity by
tests/test_torch_weights.py::test_leaf_content_hashes_match_jax, and the
sharded (dp, fsdp) layouts the JAX weight cases publish by
test_torch_weights.py's gang cases (the trees here are plain tensors).

Parity with the JAX package on the same inputs: `_pad_batch` on random
rollouts (equal), `_distill_loss_fn`'s loss and every gradient leaf on
GPT-2 tiny fp32 (2 heads, JAX's Pallas attention in interpret mode), the
frozen-leaf Adam against `optax.multi_transform` over 5 steps (frozen
leaves bit-equal), `TenantLoraTrainer`'s first 3 losses and adapter
leaves on GPT-2 and Llama tiny, the conductors' online and autoscale
aggregates for one report sequence, and the online lane's markers.
Tolerances are tests/test_ops.py's fp32 ones (atol 2e-5, rtol 2e-4) and
tests/test_torch_train.py's 1e-6 for the optimizer.

test_online_distillation_e2e's CLI and dashboard legs (`online
--json` and `/api/online` equal to the state view, `online --events`
rendering) are in its check.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu._private.conductor import ConductorHandler as JHandler
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.observability import timeline as jtimeline
from ray_tpu.online import loop as jloop
from ray_tpu.online import lora as jlora
from ray_tpu.weights.publisher import leaf_content_hashes as jhashes
from ray_tpu_torch._private import isolated, online_checks
from ray_tpu_torch._private.conductor import ConductorHandler as THandler
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.observability import timeline as ttimeline
from ray_tpu_torch.online import loop as tloop
from ray_tpu_torch.online.lora import TenantLoraTrainer
from ray_tpu_torch.train.async_checkpoint import _LeafReader
from ray_tpu_torch.train.optim import frozen_adam
from ray_tpu_torch.tree import tree_leaves, tree_map
from ray_tpu_torch.weights.publisher import leaf_content_hashes

OP_TOL = dict(atol=2e-5, rtol=2e-4)
ONLINE = {"num_cpus": 4, "_system_config": online_checks.ONLINE_CONFIG}
CHECKS = {name: ONLINE for name in (
    "online_rollout_buffer_backpressure_and_versions",
    "online_rollout_sampler_inprocess",
    "online_distillation_e2e",
    "online_delta_publish_ships_only_changed_leaves",
    "online_delta_chain_resolves_across_gcd_bases",
    "online_rapid_cadence_publication",
    "online_sync_registry_unreachable_flag",
    "online_prefetch_and_delta_fetch_bytes",
    "online_chunk_fetcher_shm_vs_rpc_accounting")}

JGPT2 = dataclasses.replace(jgpt2.GPT2Config.tiny(), num_heads=2,
                            dtype=jnp.float32)
TGPT2 = dataclasses.replace(tgpt2.GPT2Config.tiny(), num_heads=2,
                            dtype=torch.float32)
JLLAMA = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
TLLAMA = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=400.0)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def _close(got, want, **tol):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float32)
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   err_msg=f"leaf {i}", **tol)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_online_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_sampler_rollout_matches_jax_engine(outcomes):
    """The in-process sampler's rollout (prompt from the shared default
    prompt_fn and seed) is the JAX engine's greedy stream on the same
    weights, its logprobs within the fp32 tolerance."""
    ok, text = outcomes["online_rollout_sampler_inprocess"]
    assert ok, text
    got = json.loads(text)
    params, cfg = online_checks.tiny_gpt2_factory()
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, tree_map(lambda p: p.numpy(), params))
    eng = JEngine(jp, jcfg, max_batch=2)
    try:
        stream = eng.stream(got["prompt"], 6)
        want = [int(t) for t in stream]
        scores = list(stream.scores)
    finally:
        eng.stop()
    assert got["completion"] == want
    np.testing.assert_allclose(got["scores"], scores, **OP_TOL)


def test_distillation_loss_falls_and_stays_fresh(outcomes):
    ok, text = outcomes["online_distillation_e2e"]
    assert ok, text
    got = json.loads(text)
    assert got["max_staleness"] <= 1
    assert np.mean(got["losses"][-3:]) < np.mean(got["losses"][:3])


# --------------------------------------------------- weight fabric, units

def test_leaf_content_hashes_detect_changes():
    """Per-leaf hashes equal iff the leaf's bytes, shape and dtype are."""
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((8, 4))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(16)
                                  .astype(np.float32)),
            "c": torch.tensor(3, dtype=torch.int32)}
    h0 = leaf_content_hashes(tree)
    assert leaf_content_hashes(dict(tree)) == h0
    assert h0 == jhashes(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                      tree))
    h1 = leaf_content_hashes(dict(tree, a=tree["a"] * 1.5))
    assert h1[0] != h0[0] and h1[1:] == h0[1:]
    assert leaf_content_hashes(dict(tree, b=tree["b"].reshape(4, 4)))[1] \
        != h0[1]
    assert leaf_content_hashes(dict(tree, b=tree["b"].half()))[1] != h0[1]


def test_leaf_reader_prefers_covering_shards_in_order():
    """Shard order is the preference; a shard whose region is covered
    already is never loaded."""
    calls = []

    def loader(shard):
        calls.append(shard["tag"])
        if shard["tag"] == "remote":
            raise AssertionError("remote replica must not be loaded")
        return np.arange(32, dtype=np.float32).reshape(8, 4)

    shards = [{"tag": "local", "index": [[0, 8, 1], [0, 4, 1]]},
              {"tag": "remote", "index": [[0, 8, 1], [0, 4, 1]]}]
    r = _LeafReader(None, (8, 4), np.float32, shards, loader=loader)
    np.testing.assert_array_equal(
        r.read((slice(0, 8), slice(0, 4))),
        np.arange(32, dtype=np.float32).reshape(8, 4))
    assert calls == ["local"]
    r2 = _LeafReader(None, (8, 4), np.float32, shards[::-1], loader=loader)
    with pytest.raises(AssertionError):
        r2.read((slice(0, 8), slice(0, 4)))


# --------------------------------------------------------------- parity

@pytest.mark.parametrize("seed", range(3))
def test_pad_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rollouts = []
    for i in range(int(rng.integers(1, 9))):
        p = int(rng.integers(1, 9))
        c = int(rng.integers(0, 13))
        rollouts.append({
            "prompt": rng.integers(1, 500, p).astype(np.int32),
            "completion": rng.integers(1, 500, c).astype(np.int32),
            "weights_version": (None if rng.random() < 0.2
                                else int(rng.integers(1, 9)))})
    seq_len = int(rng.integers(4, 24))
    got = tloop._pad_batch(rollouts, seq_len)
    want = jloop._pad_batch(rollouts, seq_len)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    coll = tloop._collate(rollouts, seq_len)
    assert coll["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(coll["tokens"].numpy(), want["tokens"])


def _distill_batch(seed, b=2, seq_len=33):
    rng = np.random.default_rng(seed)
    rollouts = [{"prompt": rng.integers(1, 500, int(rng.integers(2, 9)))
                 .astype(np.int32),
                 "completion": rng.integers(1, 500, 24).astype(np.int32),
                 "weights_version": 1} for _ in range(b)]
    return jloop._pad_batch(rollouts, seq_len)


def test_distill_loss_and_grads_match_jax(interpret):
    """`_distill_loss_fn` (gpt2_hidden, an fp32 product against wte,
    log_softmax, the masked mean) and every gradient leaf against
    jax.value_and_grad of JAX's, whose attention runs the Pallas kernels
    in interpret mode."""
    jp = jgpt2.gpt2_init(JGPT2, jax.random.PRNGKey(3))
    batch = _distill_batch(4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k != "versions"}
    jloss, jgrads = jax.value_and_grad(jloop._distill_loss_fn(JGPT2))(
        jp, jbatch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    tbatch = {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64)),
              "targets": torch.from_numpy(batch["targets"]
                                          .astype(np.int64)),
              "mask": torch.from_numpy(batch["mask"])}
    loss = tloop._distill_loss_fn(TGPT2)(tp, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), **OP_TOL)
    grads = iter(torch.autograd.grad(loss, leaves))
    _close(tree_map(lambda _: next(grads), tp), jgrads, **OP_TOL)


def test_frozen_adam_matches_optax_multi_transform():
    """5 updates of `frozen_adam` against optax.multi_transform({"train":
    adam, "freeze": set_to_zero}) on a GPT-2-shaped tree: the frozen
    leaves bit-equal to their start, the others and their moments held as
    the port's AdamW is held against optax; no state for a frozen leaf."""
    rng = np.random.default_rng(11)
    tree = {"wte": rng.standard_normal((16, 8), dtype=np.float32),
            "wpe": rng.standard_normal((6, 8), dtype=np.float32),
            "blocks": [{"w": rng.standard_normal((8, 8), dtype=np.float32),
                        "b": rng.standard_normal(8, dtype=np.float32)}],
            "ln_f": {"scale": rng.standard_normal(8, dtype=np.float32)}}
    frozen = ("wpe",)

    def label_fn(params):
        return {k: jax.tree.map(
            lambda _: "freeze" if k in frozen else "train", v)
            for k, v in params.items()}

    jopt = optax.multi_transform({"train": optax.adam(1e-2),
                                  "freeze": optax.set_to_zero()}, label_fn)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    topt = frozen_adam(1e-2, frozen)
    tparams = from_jax_params(tree, device="cpu")
    wpe0 = tparams["wpe"].clone()
    tstate = topt.init(tparams)
    assert "wpe" not in tstate["mu"] and "wpe" not in tstate["nu"]
    for _ in range(5):
        grads = tree_map(
            lambda a: rng.standard_normal(a.shape, dtype=np.float32), tree)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.update_([torch.from_numpy(g) for g in tree_leaves(grads)],
                     tstate, tparams)
    assert torch.equal(tparams["wpe"], wpe0)
    assert np.array_equal(np.asarray(jparams["wpe"]), tree["wpe"])
    tol = dict(atol=1e-6, rtol=1e-6)
    _close(tparams, jparams, **tol)
    adam = jstate.inner_states["train"].inner_state[0]
    assert tstate["count"] == int(adam.count) == 5
    train = {k: v for k, v in jparams.items() if k not in frozen}
    _close(tstate["mu"], {k: adam.mu[k] for k in train}, **tol)
    _close(tstate["nu"], {k: adam.nu[k] for k in train}, **tol)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_tenant_lora_trainer_matches_jax(family, interpret):
    """TenantLoraTrainer's first 3 losses and adapter leaves against the
    JAX trainer's from the same base, seed and batches."""
    if family == "gpt2":
        jcfg, tcfg = JGPT2, TGPT2
        jp = jgpt2.gpt2_init(jcfg, jax.random.PRNGKey(5))
    else:
        jcfg, tcfg = JLLAMA, TLLAMA
        jp = jllama.llama_init(jcfg, jax.random.PRNGKey(5))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    # Adam moves every coordinate by about the learning rate whatever its
    # gradient's size, so a gradient that nearly cancels in fp32 moves a
    # whole step on rounding alone: at the default 1e-2 one coordinate of
    # Llama's wv.a lands 3.7e-5 from JAX's. At 1e-3 such a step stays
    # inside the fp32 op tolerance.
    kw = dict(rank=4, scale=2.0, learning_rate=1e-3, seed=7)
    jt = jlora.TenantLoraTrainer(jp, jcfg, "t", **kw)
    tt = TenantLoraTrainer(tp, tcfg, "t", **kw)
    rng = np.random.default_rng(8)
    for _ in range(3):
        batch = rng.integers(1, jcfg.vocab_size, (2, 17)).astype(np.int32)
        jt.step(batch)
        tt.step(batch)
    np.testing.assert_allclose(tt.losses, jt.losses, **OP_TOL)
    got, want = tt.adapter(), jt.adapter()
    assert got["scale"] == want["scale"]
    assert sorted(got["targets"]) == sorted(want["targets"])
    for name, ab in want["targets"].items():
        for k in ("a", "b"):
            np.testing.assert_allclose(got["targets"][name][k], ab[k],
                                       err_msg=f"{name}.{k}", **OP_TOL)


def _online_sequence(h):
    h.report_online_stats("w1", "sampler/s0", {
        "role": "sampler", "rollouts": 5, "rollout_tokens": 40,
        "swap_count": 2, "staleness_versions": 0,
        "max_staleness_versions": 1, "weights_name": "x"})
    h.report_online_stats("w2", "sampler/s1", {
        "role": "sampler", "rollouts": 3, "rollout_tokens": 24,
        "swap_count": 1, "staleness_versions": 1,
        "max_staleness_versions": None, "weights_name": "x"})
    h.report_online_stats("w1", "buffer/x", {
        "role": "buffer", "occupancy": 4, "capacity": 16, "rejected": 2})
    h.report_online_stats("d", "learner/r", {
        "role": "learner", "steps": 6, "ingested_rollouts": 48,
        "ingested_tokens": 300, "published_version": 4})
    h.report_online_event({"kind": "rollout", "sampler": "s0",
                           "weights_version": 2})
    h.report_autoscale_stats("d", "a1", {
        "scale_ups": {"prefill": 1, "decode": 2},
        "scale_downs": {"prefill": 0, "decode": 1},
        "drains_completed": 1, "drains_forced": 0,
        "replica_seconds": {"prefill": 3.5, "decode": 7.25},
        "prefill_active": 1, "decode_active": 2})
    h.report_autoscale_event({"kind": "scale_up", "tier": "decode",
                              "to": 2})
    on, au = h.get_online_status(), h.get_autoscale_status()
    return {"online_totals": on["totals"],
            "online_roles": {r: sorted(on[r]) for r in
                             ("samplers", "buffers", "learners")},
            "autoscale_totals": au["totals"],
            "autoscalers": sorted(au["autoscalers"]),
            "events": ([e["kind"] for e in h.get_online_events()],
                       [e["kind"] for e in h.get_autoscale_events()])}


def test_conductor_online_and_autoscale_aggregates_match_jax(tmp_path):
    jh = JHandler({"CPU": 2.0}, str(tmp_path / "j"))
    th = THandler({"CPU": 2.0}, str(tmp_path / "t"))
    try:
        assert _online_sequence(th) == _online_sequence(jh)
    finally:
        jh._stopped = th._stopped = True


def test_online_trace_events_match_jax():
    events = [{"kind": "rollout", "sampler": "s0", "tokens": 8,
               "weights_version": 3, "ts": 1.0},
              {"kind": "publish", "version": 4, "step": 2, "ts": 2.0,
               "delta": True},
              {"kind": "ingest", "step": 2, "rollouts": 8, "ts": 3.0},
              {"kind": "swap", "sampler": "s1", "from_version": 2,
               "to_version": 3, "ts": 4.0},
              {"kind": "no_ts"}]
    assert ttimeline.online_trace_events(events) \
        == jtimeline.online_trace_events(events)
