"""MPMD pipelines of the port (ray_tpu_torch/mpmd/, analysis/pipelines,
the conductor's pipeline surface) against the JAX package's, on the CPU.

Twins of tests/test_mpmd.py. The schedules and the bubble lint are held
against JAX's own functions on the same arguments. Each cluster case is
a check of `_private/mpmd_checks.py` run in a driver process of its own
(`isolated.run_checks`): the chunk and channel cases, the two-stage MLP
pipeline (its losses held here against the JAX test's own
`_dense_reference()`, rtol 1e-4 / atol 1e-5 as there; its registry,
timeline and metric-snapshot legs in the check), the surfaces' one set
of numbers (its Prometheus leg among them; and the stages' params after
it against the same JAX reference), stage death, and the SPMD pipeline's microbatch check.

The slice as a whole: Llama tiny fp32 as a two-stage PipelineTrainer
(embedding + block 0 | block 1 + norm_f + lm_head + loss) under both
schedules, adamw(1e-3), M 4, 3 steps on CPU stages; its losses against
JAX's `llama_loss` gradients accumulated per microbatch over the same
params and stepped with `optax.adamw(1e-3)`, at fp32 tolerance (rtol
2e-4, atol 2e-5), and each stage's final params under
tests/test_torch_train.py's Adam rule. A channel carries a bf16 and an
fp32 tree bit for bit.

The CLI and dashboard legs (`pipeline --json`, `pipeline --events`,
`/api/pipeline`) are in `mpmd_all_surfaces_report_consistent_numbers`.

Not twinned: test_builtin_pipeline_layouts_report_bubble
(analysis/layouts.py, ROADMAP Queue 1 item 7).
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

import test_mpmd as jtest
from ray_tpu.analysis import check_pipeline_schedule as jcheck
from ray_tpu.models import llama as jllama
from ray_tpu.mpmd import schedule as jsched
from ray_tpu_torch._private import isolated, mpmd_checks
from ray_tpu_torch.mpmd import schedule as tsched

CLUSTER = {"num_cpus": 4}
CHECKS = {**{name: CLUSTER for name in (
    "mpmd_chunk_tree_roundtrip_local",
    "mpmd_chunk_tree_fetch_is_point_to_point",
    "mpmd_channel_roundtrip_and_retention",
    "mpmd_channel_prefetch_overlaps_and_keeps_accounting",
    "mpmd_channel_generations_do_not_cross",
    "mpmd_channel_keeps_bits",
    "mpmd_two_stage_pipeline_matches_dense_reference",
    "mpmd_all_surfaces_report_consistent_numbers",
    "mpmd_stage_death_fails_pipeline_fast",
    "mpmd_llama_pipeline_1f1b",
    "mpmd_llama_pipeline_gpipe")},
    "mpmd_pipeline_validates_microbatches": None}

# tests/test_torch_train.py's Adam rule for parameters after adamw steps
ADAM_TOL = dict(atol=1e-4, rtol=1e-4)
FP32_TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=400.0)


def _value(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
    return json.loads(text)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_mpmd_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------------------ schedules

def _ops(ticks):
    return [str(t) for t in ticks]


def test_1f1b_tick_order():
    s0 = tsched.one_f_one_b_schedule(0, 2, 4)
    s1 = tsched.one_f_one_b_schedule(1, 2, 4)
    assert _ops(s0) == ["F0", "F1", "B0", "F2", "B1", "F3", "B2", "B3"]
    assert _ops(s1) == ["F0", "B0", "F1", "B1", "F2", "B2", "F3", "B3"]
    assert _ops(s0) == _ops(jsched.one_f_one_b_schedule(0, 2, 4))
    assert _ops(s1) == _ops(jsched.one_f_one_b_schedule(1, 2, 4))


def test_gpipe_tick_order():
    ticks = tsched.gpipe_schedule(0, 3, 3)
    assert _ops(ticks) == ["F0", "F1", "F2", "B0", "B1", "B2"]
    assert _ops(ticks) == _ops(jsched.gpipe_schedule(0, 3, 3))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("s,m", [(2, 4), (3, 7), (4, 16), (5, 1)])
def test_schedules_complete_and_deadlock_free(schedule, s, m):
    """Every (op, mb) exactly once per stage, the global order executable
    under channel semantics, and each stage's ticks JAX's."""
    schedules = {st: tsched.stage_schedule(schedule, st, s, m)
                 for st in range(s)}
    for st, ticks in schedules.items():
        assert sorted((t.op, t.mb) for t in ticks) == sorted(
            [("F", i) for i in range(m)] + [("B", i) for i in range(m)])
        assert _ops(ticks) == _ops(jsched.stage_schedule(schedule, st, s,
                                                         m))
    tsched.validate_dependencies(schedules, s, m)
    with pytest.raises(AssertionError, match="deadlocks"):
        broken = dict(schedules)
        broken[s - 1] = list(reversed(schedules[s - 1]))
        tsched.validate_dependencies(broken, s, m)


def test_1f1b_bounds_live_activations():
    s, m = 4, 16
    for stage in range(s):
        got = tsched.max_live_activations("1f1b", stage, s, m)
        assert got <= s - stage
        assert got == jsched.max_live_activations("1f1b", stage, s, m)
        assert tsched.max_live_activations("gpipe", stage, s, m) == m


def test_bubble_fraction_formula():
    assert tsched.bubble_fraction("gpipe", 4, 16) == pytest.approx(3 / 19)
    assert tsched.bubble_fraction("1f1b", 2, 4) == pytest.approx(1 / 5)
    for args in (("gpipe", 4, 16), ("1f1b", 2, 4), ("1f1b", 8, 3)):
        assert tsched.bubble_fraction(*args) == \
            jsched.bubble_fraction(*args)
    with pytest.raises(ValueError):
        tsched.bubble_fraction("zigzag", 2, 4)


def test_shardlint_bubble_info_and_warning():
    """The pipeline-bubble rule: INFO with the (S-1)/(M+S-1) estimate,
    WARNING past 20% with the M >= 4*S hint; each finding JAX's."""
    from ray_tpu_torch.analysis import (RULES, check_pipeline_schedule,
                                        format_report)

    assert "pipeline-bubble" in RULES
    ok = check_pipeline_schedule(4, 16, "gpipe", where="l/schedule")
    assert len(ok) == 1 and ok[0].severity == "info"
    assert "15.8%" in ok[0].message and "S=4" in ok[0].message
    bad = check_pipeline_schedule(4, 4, "1f1b")
    assert len(bad) == 1 and bad[0].severity == "warning"
    assert "M >= 4*S" in bad[0].fix_hint and "M >= 16" in bad[0].fix_hint
    for got, want in ((ok, jcheck(4, 16, "gpipe", where="l/schedule")),
                      (bad, jcheck(4, 4, "1f1b"))):
        assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
        assert format_report(got).splitlines()[-1] == \
            "1 finding(s): 0 error, {} warning, {} info".format(
                int(got[0].severity == "warning"),
                int(got[0].severity == "info"))


def test_make_pipeline_fn_validates_microbatches(outcomes):
    msg = _value(outcomes, "mpmd_pipeline_validates_microbatches")["message"]
    assert "num_microbatches=3" in msg
    assert "global batch 16" in msg and "'dp': 2" in msg


# ------------------------------------------------------ MLP pipelines

def test_mlp_inputs_are_the_jax_tests():
    """The check's params and data are tests/test_mpmd.py's, bit for
    bit."""
    for got, want in zip(mpmd_checks.mlp_params(), jtest._params()):
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for step in range(jtest.STEPS):
        for got, want in zip(mpmd_checks.mlp_data(step), jtest._data(step)):
            np.testing.assert_array_equal(got, want)
    assert (mpmd_checks.D, mpmd_checks.LR, mpmd_checks.M,
            mpmd_checks.STEPS) == (jtest.D, jtest.LR, jtest.M, jtest.STEPS)


def test_two_stage_pipeline_matches_dense_reference(outcomes):
    out = _value(outcomes, "mpmd_two_stage_pipeline_matches_dense_reference")
    assert len(out["losses"]) == jtest.STEPS
    np.testing.assert_allclose(out["losses"], jtest._dense_reference(),
                               rtol=1e-4, atol=1e-5)
    assert out["run_id"].startswith("mpmd/parity/")
    assert all(0.0 <= f <= 1.0 for f in out["bubble_fraction"])


def _jax_mlp_params(steps):
    """The JAX test's dense reference's params after `steps` steps."""
    p0, p1 = jtest._params()
    params = {"p0": p0, "p1": p1}
    opt = optax.sgd(jtest.LR)
    state = opt.init(params)

    def full_loss(p, x, t):
        return jtest._loss(jtest._stage1(p["p1"],
                                         jtest._stage0(p["p0"], x)), t)

    for step in range(steps):
        x, t = jtest._data(step)
        xs, ts = x.reshape(jtest.M, -1, jtest.D), t.reshape(jtest.M, -1, 1)
        acc = None
        for i in range(jtest.M):
            g = jax.grad(full_loss)(params, xs[i], ts[i])
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        grads = jax.tree.map(lambda a: a / jtest.M, acc)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return [params["p0"], params["p1"]]


def test_all_surfaces_report_consistent_numbers(outcomes):
    """The surfaces agree (in the check); the GPipe run's losses and its
    stages' params after 2 steps (`stage_params_snapshot`) are the JAX
    dense reference's."""
    out = _value(outcomes, "mpmd_all_surfaces_report_consistent_numbers")
    np.testing.assert_allclose(out["losses"], jtest._dense_reference()[:2],
                               rtol=1e-4, atol=1e-5)
    for got, want in zip(out["params"], _jax_mlp_params(2)):
        for g, w in zip(mpmd_checks.unpack(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


def test_stage_death_fails_pipeline_fast(outcomes):
    out = _value(outcomes, "mpmd_stage_death_fails_pipeline_fast")
    assert out["elapsed_s"] < 25.0 and out["error"] == "ActorDiedError"


# ------------------------------------------------- Llama tiny, the slice

@pytest.fixture(scope="module")
def jax_llama():
    """JAX's dense reference on the check's Llama tiny params and data:
    llama_loss gradients per microbatch, summed, / M, optax.adamw(1e-3).
    Returns (losses, final params split by stage, the first step's
    gradients split by stage)."""
    _, tparams = mpmd_checks.tiny_llama()
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    vg = jax.jit(jax.value_and_grad(
        lambda p, a, b: jllama.llama_loss(p, a, b, jcfg)))
    opt = optax.adamw(mpmd_checks.LLAMA_LR)
    state = opt.init(params)
    m = mpmd_checks.M
    losses, first = [], None
    for step in range(mpmd_checks.LLAMA_STEPS):
        x, t = mpmd_checks.llama_data(step)
        xs, ts = x.reshape(m, -1, x.shape[1]), t.reshape(m, -1, t.shape[1])
        acc, step_losses = None, []
        for i in range(m):
            loss, g = vg(params, xs[i], ts[i])
            step_losses.append(float(loss))
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        grads = jax.tree.map(lambda a: a / m, acc)
        if first is None:
            first = grads
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(np.mean(step_losses)))
    return (losses, mpmd_checks.llama_split(params),
            mpmd_checks.llama_split(first))


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_llama_pipeline_matches_jax(outcomes, jax_llama, schedule):
    out = _value(outcomes, f"mpmd_llama_pipeline_{schedule}")
    want_losses, want_params, first = jax_llama
    np.testing.assert_allclose(out["losses"], want_losses, **FP32_TOL)
    assert len(out["params"]) == 2
    for got, want, grad in zip(out["params"], want_params, first):
        got = mpmd_checks.unpack(got)
        want, grad = jax.tree.leaves(want), jax.tree.leaves(grad)
        assert len(got) == len(want)
        for i, (g, w, g0) in enumerate(zip(got, want, grad)):
            w, tiny = np.asarray(w), np.abs(np.asarray(g0)) < 1e-7
            np.testing.assert_allclose(g[~tiny], w[~tiny],
                                       err_msg=f"leaf {i}", **ADAM_TOL)
            np.testing.assert_allclose(g[tiny], w[tiny], atol=5e-3,
                                       err_msg=f"leaf {i}")


def test_llama_stages_compose_to_llama_loss():
    """The stage split of the check is Llama's own loss: stage 1's loss
    of stage 0's output equals `llama_loss` on the same microbatch."""
    from ray_tpu_torch.models.llama import llama_loss

    cfg, params = mpmd_checks.tiny_llama()
    p0, p1 = mpmd_checks.llama_split(params)
    x, t = (torch.from_numpy(a[:2]) for a in mpmd_checks.llama_data(0))
    with torch.no_grad():
        got = mpmd_checks.llama_tail_loss(
            mpmd_checks.llama_stage1(p1, mpmd_checks.llama_stage0(p0, x,
                                                                  cfg), cfg),
            t, cfg)
        want = llama_loss(params, x, t, cfg)
    assert torch.equal(got, want)


# --------------------------------------------- the program, in process

def test_stage_program_grads_match_jax_vjp():
    """StageProgram's recomputed backward on a mid stage (dX and the
    param grads for a given dY) and a last stage's loss-and-grad against
    jax.vjp / jax.value_and_grad of the JAX test's stages."""
    from ray_tpu_torch.mpmd.stage import StageProgram
    from ray_tpu_torch.train.optim import sgd

    p0, p1 = jtest._params()
    x, t = jtest._data(0)
    dy = np.random.default_rng(3).standard_normal((8, jtest.D)).astype(
        np.float32)
    tp0 = {k: torch.from_numpy(np.array(v)) for k, v in p0.items()}
    tp1 = {k: torch.from_numpy(np.array(v)) for k, v in p1.items()}
    mid = StageProgram(mpmd_checks.mlp_stage0, tp0, sgd(0.1),
                       needs_input_grad=True)
    y = mid.forward(0, torch.from_numpy(x))
    gx = mid.backward(0, dy=torch.from_numpy(dy))
    jy, vjp = jax.vjp(jtest._stage0, p0, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **FP32_TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(
            mid._grad_acc[list(tp0).index(k)].numpy(),
            np.asarray(jgp[k]), **FP32_TOL)
    last = StageProgram(mpmd_checks.mlp_stage1, tp1, sgd(0.1),
                        loss_fn=mpmd_checks.mse_loss, is_last=True)
    h = np.array(jy)
    assert last.forward(0, torch.from_numpy(h)) is None
    loss, gh = last.backward(0, target=torch.from_numpy(t))
    (jloss, (jgp1, jgh)) = jax.value_and_grad(
        lambda p, hh: jtest._loss(jtest._stage1(p, hh), jnp.asarray(t)),
        argnums=(0, 1))(p1, jnp.asarray(h))
    np.testing.assert_allclose(float(loss), float(jloss), **FP32_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), **FP32_TOL)
    assert last.live_activations == 0
    with pytest.raises(RuntimeError, match="apply_update"):
        StageProgram(mpmd_checks.mlp_stage1, tp1, sgd(0.1),
                     loss_fn=mpmd_checks.mse_loss,
                     is_last=True).apply_update()


def test_sgd_matches_optax():
    from ray_tpu_torch.train.optim import sgd

    rng = np.random.default_rng(4)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    g = rng.standard_normal((5, 7)).astype(np.float32)
    params = {"w": torch.from_numpy(w.copy())}
    opt = sgd(0.05)
    state = opt.init(params)
    opt.update_([torch.from_numpy(g)], state, params)
    jopt = optax.sgd(0.05)
    upd, _ = jopt.update({"w": jnp.asarray(g)},
                         jopt.init({"w": jnp.asarray(w)}))
    want = optax.apply_updates({"w": jnp.asarray(w)}, upd)["w"]
    assert np.array_equal(params["w"].numpy(), np.asarray(want))


# ---------------------------------------------------- config plumbing

def test_mpmd_exports_match_jax():
    import ray_tpu.mpmd as jmpmd
    import ray_tpu_torch.mpmd as tmpmd
    import ray_tpu_torch.train as ttrain

    public = {n for n in dir(jmpmd) if not n.startswith("_")
              and n not in ("channels", "conductor", "metrics", "schedule",
                            "stage", "trainer")}
    assert public <= set(dir(tmpmd)), public - set(dir(tmpmd))
    assert ttrain.PipelineTrainer is tmpmd.PipelineTrainer


def test_scaling_config_num_stages():
    from ray_tpu_torch.train import ScalingConfig

    assert ScalingConfig().num_stages == 1
    assert ScalingConfig(num_stages=4).num_stages == 4


def test_pipeline_trainer_rejects_stage_mismatch():
    from ray_tpu_torch.train import PipelineTrainer, ScalingConfig
    from ray_tpu_torch.train.optim import sgd

    with pytest.raises(ValueError, match="num_stages"):
        PipelineTrainer([mpmd_checks.mlp_stage0, mpmd_checks.mlp_stage1],
                        [None, None], mpmd_checks.mse_loss, sgd(0.05),
                        data_fn=mpmd_checks.mlp_data, num_microbatches=4,
                        scaling_config=ScalingConfig(num_stages=3))


def test_multi_host_stage_gangs_refused_loudly():
    from ray_tpu_torch.mpmd import PipelineConductor
    from ray_tpu_torch.train import PipelineTrainer, ScalingConfig
    from ray_tpu_torch.train.optim import sgd

    fns = [mpmd_checks.mlp_stage0, mpmd_checks.mlp_stage1]
    with pytest.raises(NotImplementedError, match="one host per stage"):
        PipelineTrainer(fns, [None, None], mpmd_checks.mse_loss, sgd(0.05),
                        data_fn=mpmd_checks.mlp_data, num_microbatches=4,
                        scaling_config=ScalingConfig(num_stages=2,
                                                     num_workers=8))
    with pytest.raises(NotImplementedError, match="one host per stage"):
        PipelineConductor("x", fns, [None, None], sgd(0.05),
                          mpmd_checks.mse_loss, num_microbatches=4,
                          hosts_per_stage=2)


def test_cuda_pipeline_without_cuda_raises():
    """A pipeline asked for CUDA (the default) raises without it, before
    touching any cluster; device= names the CPU."""
    from ray_tpu_torch.mpmd import PipelineConductor
    from ray_tpu_torch.train.optim import sgd

    assert not torch.cuda.is_available()
    fns = [mpmd_checks.mlp_stage0, mpmd_checks.mlp_stage1]
    for device in ("cuda", ["cpu", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PipelineConductor("x", fns, [None, None], sgd(0.05),
                              mpmd_checks.mse_loss, num_microbatches=4,
                              device=device)
    with pytest.raises(ValueError, match="3 devices for 2 stages"):
        PipelineConductor("x", fns, [None, None], sgd(0.05),
                          mpmd_checks.mse_loss, num_microbatches=4,
                          device=["cpu"] * 3)


def test_step_timer_has_bubble_wait_phase():
    from ray_tpu_torch.observability.step_timer import PHASES, StepTimer

    assert "bubble_wait" in PHASES
    timer = StepTimer("t", enabled=True)
    timer.record("bubble_wait", 0.25)
    timer.record("device_step", 0.05)
    rec = timer.end_step()
    assert rec["bubble_wait_ms"] == pytest.approx(250.0)
