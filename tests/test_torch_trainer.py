"""The port's trainer (ray_tpu_torch.train: TorchTrainer, the session,
the configs, the restart backoff) against the JAX package's JaxTrainer in
its spmd mode, on the CPU.

The retry loop, the async-checkpoint registration and the session's
StepTimer keys are the twins of tests/test_resilience.py and
tests/test_async_checkpoint.py. Resume parity: GPT-2 tiny fp32 (2 heads,
as tests/test_torch_train.py; JAX weights carried over with
`from_jax_params`) trains 6 steps through each trainer, checkpointing
every 2 steps with `async_save`; attempt 0 fails after step 5 and
attempt 1 resumes from step 4. The port's final parameters are bit-equal
to its uninterrupted run, and within tests/test_ops.py's fp32 tolerance
(1e-4) of JAX's, Adam's near-noise elements held to 6 steps of lr as
tests/test_torch_train.py holds them.
"""
from __future__ import annotations

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import train as jtrain
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu.resilience import supervisor as jsup
from ray_tpu.train import async_checkpoint as jac
from ray_tpu.train import config as jconfig
from ray_tpu.train.trainer import TrainStep as JTrainStep
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.resilience import supervisor as tsup
from ray_tpu_torch.train import async_checkpoint as tac
from ray_tpu_torch.train import config as tconfig
from ray_tpu_torch.train import session as tsession
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.step import TrainStep
from ray_tpu_torch.tree import tree_leaves, tree_map

JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), num_heads=2,
                           dtype=jnp.float32)
TCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), num_heads=2,
                           dtype=torch.float32)
TOL = dict(atol=1e-4, rtol=1e-4)
LR, STEPS, EVERY, FAIL_AT = 1e-3, 6, 2, 5

# the StepTimer keys report() merges, JAX's names
TIMER_KEYS = ("step_time_ms", "data_wait_ms", "bubble_wait_ms",
              "compile_ms", "device_step_ms", "checkpoint_ms", "report_ms",
              "other_ms", "tokens_per_sec")


# ------------------------------------------------------------- configs

def test_configs_match_jax_fields_and_defaults():
    """Every config has JAX's fields and defaults; the two fields named
    for JAX or the TPU have the port's names."""
    renamed = {"use_tpu": "use_gpu",
               "setup_jax_distributed": "setup_torch_distributed"}
    for name in ("ScalingConfig", "ShardingConfig", "CheckpointConfig",
                 "FailureConfig", "RunConfig"):
        j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
        jf = {renamed.get(k, k): v for k, v in dataclasses.asdict(j).items()}
        assert dataclasses.asdict(t) == jf, name
    for n, s in ((8, 1), (8, 2), (6, 3), (4, 4)):
        assert tconfig.assign_worker_slices(n, s) == \
            jconfig.assign_worker_slices(n, s)
    with pytest.raises(ValueError):
        tconfig.assign_worker_slices(6, 4)
    rc = dict(name="x", storage_path="/s")
    assert tconfig.RunConfig(**rc).resolved_storage_path() == \
        jconfig.RunConfig(**rc).resolved_storage_path()


@pytest.mark.parametrize("axes", [dict(dp=-1), dict(dp=2, fsdp=2, tp=2),
                                  dict(dp=1, fsdp=-1, tp=2),
                                  dict(dp=-1, dcn_dp=2)])
def test_sharding_config_lowers_like_jax(axes):
    """mesh_config() is the port's MeshConfig (HybridMeshConfig with a
    dcn axis), solving to JAX's axis sizes."""
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.parallel.multislice import HybridMeshConfig

    t = tconfig.ShardingConfig(**axes).mesh_config()
    j = jconfig.ShardingConfig(**axes).mesh_config()
    assert isinstance(t, HybridMeshConfig if "dcn_dp" in axes
                      else MeshConfig)
    assert t.sizes(8) == j.sizes(8)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_backoff_delay_matches_jax():
    for attempt in (0, 1, 2, 3, 7, 12):
        for u in (0.0, 0.5, 0.999):
            assert tsup.backoff_delay(attempt, 0.5, 8.0,
                                      rand=lambda: u) == \
                jsup.backoff_delay(attempt, 0.5, 8.0, rand=lambda: u)
    # the defaults are JAX's flag table's
    assert tsup.backoff_delay(1, rand=lambda: 0.0) == 1.0
    assert tsup.backoff_delay(9, rand=lambda: 0.0) == 30.0


# ----------------------------------------------------------- retry loop

_FAIL_COUNTS: dict = {}


def _flaky_then_ok(cfg):
    key = cfg["key"]
    _FAIL_COUNTS[key] = _FAIL_COUNTS.get(key, 0) + 1
    if _FAIL_COUNTS[key] <= int(cfg.get("failures", 2)):
        raise RuntimeError(f"boom {_FAIL_COUNTS[key]}")
    ttrain.report({"ok": 1, "attempts": _FAIL_COUNTS[key]})


def _trainer(fn, tmp, max_failures, **kw):
    return ttrain.TorchTrainer(
        fn, run_config=ttrain.RunConfig(
            storage_path=str(tmp), failure_config=ttrain.FailureConfig(
                max_failures=max_failures)),
        restart_backoff_base_s=0.01, restart_backoff_max_s=0.05, **kw)


def test_fit_retries_with_backoff_then_succeeds(tmp_path):
    """Twin of tests/test_resilience.py: two failures, then success on
    the third attempt after backoff; a spent budget returns the error."""
    t0 = time.monotonic()
    result = _trainer(_flaky_then_ok, tmp_path, 3,
                      train_loop_config={"key": "retry",
                                         "failures": 2}).fit()
    assert result.error is None and result.metrics["attempts"] == 3
    assert time.monotonic() - t0 >= 0.02  # backoff actually slept
    result = _trainer(_flaky_then_ok, tmp_path / "g", 1,
                      train_loop_config={"key": "give-up",
                                         "failures": 99}).fit()
    assert isinstance(result.error, RuntimeError)
    assert _FAIL_COUNTS["give-up"] == 2  # one attempt and one retry
    result = _trainer(_flaky_then_ok, tmp_path / "u", -1,
                      train_loop_config={"key": "unbounded",
                                         "failures": 4}).fit()
    assert result.error is None and result.metrics["attempts"] == 5


@pytest.mark.parametrize("exc", [KeyboardInterrupt, SystemExit])
def test_fit_does_not_swallow_interrupts(tmp_path, exc):
    def interrupting(cfg):
        raise exc

    with pytest.raises(exc):
        _trainer(interrupting, tmp_path, -1).fit()


def test_workers_mode_raises_until_the_runtime_is_ported(tmp_path):
    """The workers mode runs a gang of actor ranks (tests/
    test_torch_train_gang.py drives it on a cluster): without one it
    raises, naming init(), before it creates anything."""
    trainer = ttrain.TorchTrainer(
        lambda cfg: None, mode="workers",
        scaling_config=ttrain.ScalingConfig(num_workers=2),
        run_config=ttrain.RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(RuntimeError, match=r"ray_tpu_torch\.init\(\)"):
        trainer.fit()
    assert not os.path.exists(trainer.run_config.resolved_storage_path())


def test_session_surface(tmp_path):
    """Outside a session: no context, a disabled step timer, no
    preemption notice. Inside: the context, datasets sharded as JAX
    shards them, StopTrial ends the fit cleanly, publish_weights without
    a cluster raises naming init() (tests/test_torch_weights.py publishes
    on one)."""
    with pytest.raises(RuntimeError, match="No train session"):
        ttrain.get_context()
    assert ttrain.preemption_requested() is None
    timer = ttrain.get_step_timer()
    assert not timer.enabled
    with timer.phase("data_wait"):
        pass
    assert timer.end_step() is None and not timer.records
    seen = {}

    def fn(cfg):
        ctx = ttrain.get_context()
        seen.update(rank=ctx.get_world_rank(), world=ctx.get_world_size(),
                    shard=ttrain.get_dataset_shard("train"),
                    sharding=cfg["sharding_config"], lr=cfg["lr"],
                    ckpt=ttrain.get_checkpoint(),
                    timer=ttrain.get_step_timer().enabled)
        with pytest.raises(RuntimeError, match="publishing weights"):
            ttrain.report({}, publish_weights={"w": torch.ones(1)})
        raise tsession.StopTrial()

    result = ttrain.TorchTrainer(
        fn, train_loop_config={"lr": 0.1}, datasets={"train": [1, 2, 3]},
        run_config=ttrain.RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None and result.metrics == {}
    assert seen["shard"] == [1, 2, 3] and seen["lr"] == 0.1
    assert (seen["rank"], seen["world"], seen["ckpt"], seen["timer"]) == \
        (0, 1, None, True)
    assert isinstance(seen["sharding"], ttrain.ShardingConfig)
    jt = jtrain.JaxTrainer(lambda c: None, datasets={"a": [1, 2, 3, 4]})
    tt = ttrain.TorchTrainer(lambda c: None, datasets={"a": [1, 2, 3, 4]})
    for rank in range(2):
        assert tt._shard_datasets(rank, 2) == jt._shard_datasets(rank, 2)


# ---------------------------------------------- async report registration

def test_report_async_checkpoint_overlap(tmp_path):
    """Twin of tests/test_async_checkpoint.py: report(checkpoint=async)
    returns at once; the manager registers at commit and fit()'s result
    sees the checkpoint."""
    report_times = []

    def train_fn(cfg):
        state = {"w": torch.randn(16, 4)}
        w = tac.AsyncCheckpointer()
        w._test_write_delay = 0.4
        for step in range(2):
            ck = w.save(str(tmp_path / f"work_ck_{step}"), state)
            t0 = time.monotonic()
            ttrain.report({"loss": 1.0 - step * 0.1, "step": step},
                          checkpoint=ck)
            report_times.append(time.monotonic() - t0)

    result = ttrain.TorchTrainer(
        train_fn, run_config=ttrain.RunConfig(
            name="async_ck", storage_path=str(tmp_path / "exp"))).fit()
    assert result.error is None
    assert max(report_times) < 0.2, report_times
    assert result.checkpoint.path.endswith("checkpoint_000001")
    assert tac.restore(result.checkpoint.path)["w"].shape == (16, 4)


def test_async_then_sync_registration_order(tmp_path):
    """Twin: an in-flight async checkpoint reported before a sync one
    ranks older (recency by report order, not commit order)."""
    from ray_tpu_torch.train.checkpoint import save_pytree

    def train_fn(cfg):
        w = tac.AsyncCheckpointer()
        w._test_write_delay = 0.4  # commits after the sync report
        ck0 = w.save(str(tmp_path / "async0"), {"w": torch.ones(16, 4)})
        ttrain.report({"step": 0}, checkpoint=ck0)
        d = str(tmp_path / "sync1")
        save_pytree({"w": torch.ones(3)}, d)
        ttrain.report({"step": 1}, checkpoint=ttrain.Checkpoint(d))

    result = ttrain.TorchTrainer(
        train_fn, run_config=ttrain.RunConfig(
            name="order", storage_path=str(tmp_path / "exp"))).fit()
    assert result.error is None
    assert result.checkpoint.path.endswith("checkpoint_000001")


# ------------------------------------------------------ resume parity

def _batches():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, JCFG.vocab_size, (STEPS, 2, 65))
    return [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in toks]


def _jax_params():
    return jax.tree.map(np.asarray,
                        jgpt2.gpt2_init(JCFG, jax.random.PRNGKey(0)))


def _port_fn(out, batches, params_np, work):
    """train_fn: TrainStep + adamw, resuming from get_checkpoint(), an
    async checkpoint every EVERY steps, failing after FAIL_AT's report
    on attempt 0."""
    def fn(cfg):
        step = TrainStep(lambda p, b: tgpt2.gpt2_loss(
            p, b["tokens"], b["targets"], TCFG), adamw(LR), device="cpu")
        state = step.init_state(from_jax_params(params_np, device="cpu"))
        ck = ttrain.get_checkpoint()
        if ck is not None:
            state = ttrain.restore(ck.path, like=state)
        attempt = ttrain.get_context().attempt
        for s in range(int(state["step"]) + 1, STEPS + 1):
            state, m = step(state, tree_map(torch.from_numpy,
                                            batches[s - 1]))
            out["losses"][s] = float(m["loss"])
            ck = ttrain.async_save(os.path.join(work, f"a{attempt}s{s}"),
                                   state) if s % EVERY == 0 else None
            ttrain.report({"step": s, "loss": float(m["loss"])},
                          checkpoint=ck)
            if attempt == 0 and s == FAIL_AT:
                raise RuntimeError("simulated failure")
        out["state"] = state
    return fn


def _jax_fn(out, batches, params_np, work):
    def fn(cfg):
        mesh = jmake_mesh(JMeshConfig(dp=1), devices=jax.devices()[:1])
        step = JTrainStep(lambda p, b: jgpt2.gpt2_loss(
            p, b["tokens"], b["targets"], JCFG), optax.adamw(LR), mesh,
            jgpt2.gpt2_partition_specs(JCFG))
        state = step.init_state(jax.tree.map(jnp.asarray, params_np))
        ck = jtrain.get_checkpoint()
        if ck is not None:
            state = jac.restore(ck.path, like=state)
        attempt = jtrain.get_context().attempt
        for s in range(int(state["step"]) + 1, STEPS + 1):
            state, m = step(state, jax.tree.map(
                lambda a: jnp.asarray(a, jnp.int32), batches[s - 1]))
            out["losses"][s] = float(m["loss"])
            ck = jac.async_save(os.path.join(work, f"a{attempt}s{s}"),
                                state) if s % EVERY == 0 else None
            jtrain.report({"step": s, "loss": float(m["loss"])},
                          checkpoint=ck)
            if attempt == 0 and s == FAIL_AT:
                raise RuntimeError("simulated failure")
        out["state"] = jax.tree.map(np.asarray, state)
    return fn


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Both trainers' resumed runs, and the port's uninterrupted one."""
    tmp = tmp_path_factory.mktemp("resume")
    batches, params = _batches(), _jax_params()
    mp = pytest.MonkeyPatch()
    mp.setenv("RAY_TPU_RESTART_BACKOFF_BASE_S", "0.01")
    try:
        runs = {}
        for name, make, trainer in (
                ("port", _port_fn, lambda fn, rc: ttrain.TorchTrainer(
                    fn, run_config=rc, restart_backoff_base_s=0.01)),
                ("jax", _jax_fn, lambda fn, rc: jtrain.JaxTrainer(
                    fn, run_config=rc))):
            out = {"losses": {}}
            rc_kw = dict(name=name, storage_path=str(tmp / "exp"))
            rc = (ttrain if name == "port" else jtrain).RunConfig(
                checkpoint_config=(ttrain if name == "port" else jtrain)
                .CheckpointConfig(num_to_keep=2),
                failure_config=(ttrain if name == "port" else jtrain)
                .FailureConfig(max_failures=1), **rc_kw)
            result = trainer(make(out, batches, params,
                                  str(tmp / f"work_{name}")), rc).fit()
            runs[name] = (result, out)
    finally:
        mp.undo()
    step = TrainStep(lambda p, b: tgpt2.gpt2_loss(
        p, b["tokens"], b["targets"], TCFG), adamw(LR), device="cpu")
    state = step.init_state(from_jax_params(params, device="cpu"))
    losses = []
    for b in batches:
        state, m = step(state, tree_map(torch.from_numpy, b))
        losses.append(float(m["loss"]))
    # Adam's near-noise elements (tests/test_torch_train.py): the first
    # gradient at the fp32 noise of its sum
    p0 = from_jax_params(params, device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(p0)]
    first = iter(torch.autograd.grad(tgpt2.gpt2_loss(
        p0, torch.from_numpy(batches[0]["tokens"]),
        torch.from_numpy(batches[0]["targets"]), TCFG), leaves))
    noise = tree_map(lambda _: next(first).abs().numpy() < 1e-7, p0)
    return runs, {"state": state, "losses": losses, "noise": noise}


def test_resumed_run_is_bit_equal_to_uninterrupted(resumed):
    """The port's resumed run (attempt 1 from the step-4 checkpoint):
    losses of steps 5-6 and every parameter, moment, count and step
    bit-equal to the uninterrupted run."""
    runs, ref = resumed
    result, out = runs["port"]
    assert result.error is None
    assert [out["losses"][s] for s in range(1, STEPS + 1)] == ref["losses"]
    got, want = out["state"], ref["state"]
    assert got["step"] == want["step"] == STEPS
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == STEPS
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["port", "jax"])
def test_resumed_run_keeps_two_checkpoints_and_reports_the_last(resumed,
                                                                name):
    """Each trainer: the result's checkpoint is step 6's, two checkpoint
    directories remain (steps 4 and 6), and the history holds attempt 1's
    reports (steps 5 and 6)."""
    runs, _ = resumed
    result, _ = runs[name]
    assert result.error is None
    ck_root = os.path.join(result.path, "checkpoints")
    kept = sorted(os.listdir(ck_root))
    assert kept == ["checkpoint_000001", "checkpoint_000002"]
    assert result.checkpoint.path == os.path.join(ck_root, kept[-1])
    assert [m["step"] for m in result.metrics_history] == [5, 6]


def test_resumed_run_matches_jax_trainer(resumed):
    """The port's resumed run against JaxTrainer's resumed run: every
    loss within 1e-4 and the final parameters too (near-noise elements to
    6 steps of lr)."""
    runs, ref = resumed
    (_, tout), (_, jout) = runs["port"], runs["jax"]
    np.testing.assert_allclose(
        [tout["losses"][s] for s in range(1, STEPS + 1)],
        [jout["losses"][s] for s in range(1, STEPS + 1)], **TOL)
    for got, want, tiny in zip(
            jax.tree.leaves(tree_map(lambda t: t.detach().numpy(),
                                     tout["state"]["params"])),
            jax.tree.leaves(jout["state"]["params"]),
            jax.tree.leaves(ref["noise"])):
        np.testing.assert_allclose(got[~tiny], want[~tiny], **TOL)
        np.testing.assert_allclose(got[tiny], want[tiny], atol=STEPS * LR)


def test_reported_metrics_carry_jax_step_timer_keys(resumed):
    """With no timer of its own, TrainStep under a session records into
    the session's StepTimer, and report() merges its record under JAX's
    keys: the same keys in the same reports as JaxTrainer's (MFU aside:
    the port has no CPU peak)."""
    runs, _ = resumed
    (tres, _), (jres, _) = runs["port"], runs["jax"]
    assert len(tres.metrics_history) == len(jres.metrics_history)
    for t, j in zip(tres.metrics_history, jres.metrics_history):
        assert {k for k in TIMER_KEYS if k in t} == \
            {k for k in TIMER_KEYS if k in j}
        for k in ("step_time_ms", "data_wait_ms", "device_step_ms",
                  "checkpoint_ms", "tokens_per_sec"):
            assert k in t and t[k] >= 0
