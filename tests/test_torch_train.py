"""Parity of the PyTorch port's training path (ray_tpu_torch.train,
ray_tpu_torch.observability, the gradient of models.gpt2.gpt2_loss) with
the JAX package's, on the CPU.

GPT-2 `tiny()` with 2 heads (head_dim 64, so the JAX flash kernels take
it) at fp32; the same numpy tokens and JAX parameters carried over with
`from_jax_params`. The JAX Pallas kernels run in interpret mode where a
test forces them (`RAY_TPU_PALLAS_INTERPRET=1`), so its gradient goes
through the backward kernels the port's CUDA kernels replace.
Tolerances: atol/rtol 1e-4 for the losses, gradients and parameters of
a whole model (the two frameworks sum in different orders), 1e-6 for one
optimizer update.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.observability import flops as jflops
from ray_tpu.observability import step_timer as jtimer
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.train.trainer import TrainStep as JTrainStep
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import (from_jax_adamw_state,
                                          from_jax_params)
from ray_tpu_torch.observability import flops as tflops
from ray_tpu_torch.observability import step_timer as ttimer
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.step import TrainStep
from ray_tpu_torch.tree import tree_leaves, tree_map

JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), num_heads=2,
                           dtype=jnp.float32)
TCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), num_heads=2,
                           dtype=torch.float32)
TOL = dict(atol=1e-4, rtol=1e-4)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size,
                                                size=shape)


def _jax_params(seed=0):
    return jgpt2.gpt2_init(JCFG, jax.random.PRNGKey(seed))


def _torch_params(jp):
    return from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_trees_close(got, want, **tol):
    # jax orders dict keys when it flattens; torch tensors are its leaves
    got_leaves = jax.tree.leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"leaf {i}", **tol)


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """Loss and gradient of the JAX `gpt2_loss` at tokens [2, 128], with
    both Pallas paths (flash attention, fused CE) in interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    try:
        jp = _jax_params()
        tok, tgt = _tokens(1, (2, 128)), _tokens(2, (2, 128))
        loss, grads = jax.value_and_grad(jgpt2.gpt2_loss)(
            jp, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32),
            JCFG)
        return jp, tok, tgt, float(loss), grads
    finally:
        mp.undo()


@pytest.mark.parametrize("remat,chunk_rows", [(False, 2048), (True, 2048),
                                              (False, 32)])
def test_gpt2_loss_grad_matches_jax(jax_loss_and_grads, remat, chunk_rows):
    """Every parameter's gradient against jax.grad of the JAX loss: the
    port's plain backward kernels (FlashAttention's), per-block remat,
    and the checkpointed chunked loss (8 chunks)."""
    jp, tok, tgt, jloss, jgrads = jax_loss_and_grads
    tp = _torch_params(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    loss = tgpt2.gpt2_loss(tp, torch.from_numpy(tok), torch.from_numpy(tgt),
                           TCFG, remat=remat, loss_chunk_rows=chunk_rows)
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    grads = iter(torch.autograd.grad(loss, leaves))
    gtree = tree_map(lambda _: next(grads), tp)
    _assert_trees_close(gtree, jgrads, **TOL)
    # the padding rows of wte get no gradient
    assert not gtree["wte"][TCFG.vocab_size:].any()


@pytest.mark.parametrize("weight_decay", [None, 0.1])
def test_adamw_update_matches_optax(weight_decay):
    """Two updates of the port's `adamw` against `optax.adamw` with its
    default weight decay (1e-4) and with 0.1, fp32: params and moments."""
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal((8, 16), dtype=np.float32),
            "b": [rng.standard_normal(16, dtype=np.float32)]}
    kw = {} if weight_decay is None else {"weight_decay": weight_decay}
    jopt = optax.adamw(1e-2, **kw)
    topt = adamw(1e-2, **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = from_jax_params(tree, device="cpu")
    tstate = topt.init(tparams)
    for i in range(2):
        grads = tree_map(
            lambda a: rng.standard_normal(a.shape, dtype=np.float32), tree)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.update_([torch.from_numpy(g) for g in tree_leaves(grads)],
                     tstate, tparams)
    assert tstate["count"] == int(jstate[0].count) == 2
    tol = dict(atol=1e-6, rtol=1e-6)
    _assert_trees_close(tparams, jparams, **tol)
    _assert_trees_close(tstate["mu"], jstate[0].mu, **tol)
    _assert_trees_close(tstate["nu"], jstate[0].nu, **tol)


def _batches(n):
    return [{"tokens": _tokens(10 + i, (2, 64)),
             "targets": _tokens(20 + i, (2, 64))} for i in range(n)]


def _jax_steps(step, state, batches):
    losses = []
    for b in batches:
        state, m = step(state, jax.tree.map(
            lambda a: jnp.asarray(a, jnp.int32), b))
        losses.append(float(m["loss"]))
    return state, losses


def _torch_steps(step, state, batches):
    losses = []
    for b in batches:
        state, m = step(state, jax.tree.map(torch.from_numpy, b))
        losses.append(float(m["loss"]))
    return state, losses


def _loss_fns():
    return (lambda p, b: jgpt2.gpt2_loss(p, b["tokens"], b["targets"], JCFG),
            lambda p, b: tgpt2.gpt2_loss(p, b["tokens"], b["targets"], TCFG))


def test_train_step_trajectory_matches_jax():
    """Five steps of the port's TrainStep + adamw(1e-3) against the JAX
    TrainStep + optax.adamw(1e-3) on a one-device CPU mesh: every loss
    and the final parameters. Then a JAX run of two steps carried into
    the port (`from_jax_params` + `from_jax_adamw_state`) continues for
    three more in step with the JAX run."""
    jloss_fn, tloss_fn = _loss_fns()
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    specs = jgpt2.gpt2_partition_specs(JCFG)
    batches = _batches(5)

    jstep = JTrainStep(jloss_fn, optax.adamw(1e-3), mesh, specs)
    jstate, jlosses = _jax_steps(jstep, jstep.init_state(_jax_params()),
                                 batches)
    tstep = TrainStep(tloss_fn, adamw(1e-3), device="cpu")
    tstate = tstep.init_state(_torch_params(_jax_params()))
    # Adam's first update divides each gradient by its own magnitude (plus
    # eps 1e-8): where the first gradient is at the fp32 noise of its sum
    # (~1e-8 here), the two runs' first steps differ by a fraction of the
    # learning rate. Those elements are held to 5 steps of 1e-3, every
    # other element to TOL.
    first = torch.autograd.grad(
        tloss_fn(tstate["params"], jax.tree.map(torch.from_numpy,
                                                batches[0])),
        tree_leaves(tstate["params"]))
    it = iter(first)
    noise = tree_map(lambda _: next(it).abs() < 1e-7, tstate["params"])
    tstate, tlosses = _torch_steps(tstep, tstate, batches)
    assert tstate["step"] == 5
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    for got, want, tiny in zip(jax.tree.leaves(tstate["params"]),
                               jax.tree.leaves(jstate["params"]),
                               jax.tree.leaves(noise)):
        got, tiny = got.detach().numpy(), tiny.numpy()
        want = np.asarray(want)
        np.testing.assert_allclose(got[~tiny], want[~tiny], **TOL)
        np.testing.assert_allclose(got[tiny], want[tiny], atol=5e-3)

    # resume: two JAX steps, carried over, three more in both
    jstep2 = JTrainStep(jloss_fn, optax.adamw(1e-3), mesh, specs)
    jstate, _ = _jax_steps(jstep2, jstep2.init_state(_jax_params()),
                           batches[:2])
    carried = jax.tree.map(np.asarray, {"params": jstate["params"],
                                        "opt": jstate["opt_state"]})
    tparams = from_jax_params(carried["params"], device="cpu")
    tstate = tstep.init_state(tparams)
    tstate["opt_state"] = from_jax_adamw_state(carried["opt"],
                                               tstate["params"],
                                               device="cpu")
    assert tstate["opt_state"]["count"] == 2
    jstate, jlosses = _jax_steps(jstep2, jstate, batches[2:])
    tstate, tlosses = _torch_steps(tstep, tstate, batches[2:])
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    _assert_trees_close(tstate["params"], jstate["params"], **TOL)
    _assert_trees_close(tstate["opt_state"]["mu"],
                        jstate["opt_state"][0].mu, **TOL)


def test_train_step_records_phases_tokens_and_no_cpu_mfu():
    """A StepTimer handed to TrainStep gets data_wait and device_step per
    step, tokens per step and the analytic FLOPs; on the CPU there is no
    peak, so no MFU."""
    _, tloss_fn = _loss_fns()
    timer = ttimer.StepTimer()
    fpt = tflops.train_flops_per_token(TCFG, 64)
    step = TrainStep(tloss_fn, adamw(1e-3), flops_per_token=fpt,
                     device="cpu", timer=timer)
    state = step.init_state(tgpt2.gpt2_init(TCFG, device="cpu"))
    for b in _batches(2):
        state, _ = step(state, jax.tree.map(torch.from_numpy, b))
        rec = timer.end_step()
        assert rec["device_step_ms"] > 0 and rec["data_wait_ms"] >= 0
        assert rec["tokens"] == 128 and rec["tokens_per_sec"] > 0
        assert "mfu" not in rec
    assert timer.flops_per_step == fpt * 128
    assert len(timer.records) == 2
    with timer.phase("data_wait"):
        pass
    assert timer.end_step()["data_wait_ms"] >= 0 and timer.end_step() is None


def test_step_record_summary_matches_jax():
    rng = np.random.default_rng(7)
    records = [{"total_ms": float(t), "device_step_ms": float(t) * 0.9,
                "data_wait_ms": float(t) * 0.05}
               for t in rng.uniform(10, 20, size=17)]
    assert ttimer.summarize_records(records) == \
        jtimer.summarize_records(records)
    vals = sorted(r["total_ms"] for r in records)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert ttimer.percentile(vals, q) == jtimer.percentile(vals, q)


@pytest.mark.parametrize("name", ["small", "medium", "tiny"])
def test_flops_match_jax(name):
    j = getattr(jgpt2.GPT2Config, name)()
    t = getattr(tgpt2.GPT2Config, name)()
    assert tflops.param_count(t) == jflops.param_count(j)
    for seq in (None, 256):
        assert tflops.train_flops_per_token(t, seq) == \
            jflops.train_flops_per_token(j, seq)
        assert tflops.attn_flops_per_token(t, seq, causal=False) == \
            jflops.attn_flops_per_token(j, seq, causal=False)
    assert tflops.mfu(1e12, 0.5, 4e12) == jflops.mfu(1e12, 0.5, 4e12)
    assert "TPU" not in " ".join(tflops.PEAK_FLOPS_BF16)
    assert tflops.PEAK_FLOPS_BF16["NVIDIA H100 80GB HBM3"] == 989e12


def test_train_step_without_device_raises_when_cuda_is_missing():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    _, tloss_fn = _loss_fns()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainStep(tloss_fn, adamw(1e-3))
