"""Parity of the PyTorch port's Llama family (ray_tpu_torch.models.llama,
ray_tpu_torch.ops.rope, the Llama branch of generation and the engine,
training through TrainStep) with the JAX package's, on the CPU.

The configuration is `LlamaConfig.tiny()` with d_model 256, 4 query heads
and 2 kv heads at fp32: head_dim 64 and T a multiple of 128, so the JAX
flash kernels take it (with head_dim 32 JAX would silently run its
plain attention), and two kv heads each repeated twice, so repeating the
kv heads in tile order instead of in a row gives other numbers. The same
numpy tokens go into both packages and the JAX parameters are carried
over with `from_jax_params`. Where a test forces them, the JAX Pallas
kernels run in interpret mode with 128-row blocks, so dQ sums over two
kv blocks, and its backward is the single-pass (fused) kernel
(`RAY_TPU_FLASH_FUSED_BWD=1`), the backward the port's Llama always
takes. Tolerances: atol/rtol 1e-4 for the logits, losses, gradients
and parameters of a whole model (the two frameworks sum in different
orders), atol 2e-5 / rtol 2e-4 for single ops (tests/test_ops.py).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models.engine import ContinuousBatchingEngine as JEngine
from ray_tpu.models.generate import generate as jgenerate
from ray_tpu.models.generate import lora_targets as jlora_targets
from ray_tpu.observability import flops as jflops
from ray_tpu.ops import attention as jattn
from ray_tpu.ops import rope as jrope
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.train.trainer import TrainStep as JTrainStep
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (from_jax_adamw_state,
                                          from_jax_params)
from ray_tpu_torch.models.engine import ContinuousBatchingEngine
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.observability import flops as tflops
from ray_tpu_torch.ops import rope as trope
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.step import TrainStep
from ray_tpu_torch.tree import tree_leaves, tree_map

_TWIN = dict(d_model=256, num_heads=4, num_kv_heads=2, max_seq_len=256)
JCFG = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                           **_TWIN)
TCFG = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32,
                           **_TWIN)
TOL = dict(atol=1e-4, rtol=1e-4)
OP_TOL = dict(atol=2e-5, rtol=2e-4)
PRESETS = ["tiny", "small", "llama2_7b", "llama3_8b"]


def _tokens(seed, shape, vocab=JCFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _jax_params(seed=0, cfg=JCFG):
    return jllama.llama_init(cfg, jax.random.PRNGKey(seed))


def _torch_params(jp):
    return from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _pallas_fused(mp: pytest.MonkeyPatch) -> None:
    """JAX attention through its Pallas kernels in interpret mode, 128-row
    blocks, the single-pass backward."""
    mp.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    mp.setenv("RAY_TPU_FLASH_FUSED_BWD", "1")
    mp.setattr(jattn, "DEFAULT_BLOCK_Q", 128)
    mp.setattr(jattn, "DEFAULT_BLOCK_K", 128)


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
def params():
    jp = _jax_params()
    return jp, _torch_params(jp)


@pytest.mark.parametrize("name", PRESETS)
def test_config_matches_jax(name):
    j = getattr(jllama.LlamaConfig, name)()
    t = getattr(tllama.LlamaConfig, name)()
    fields = ("vocab_size", "max_seq_len", "num_layers", "num_heads",
              "num_kv_heads", "d_model", "d_ff", "rope_theta",
              "vocab_pad_multiple", "head_dim", "padded_vocab")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


def test_params_keep_the_jax_layout(params):
    jp, tp = params
    init = tllama.llama_init(TCFG, torch.Generator().manual_seed(0),
                             device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node_t, node_i = tp, init
        for key in path:
            k = key.key if hasattr(key, "key") else key.idx
            node_t, node_i = node_t[k], node_i[k]
        assert tuple(node_t.shape) == tuple(leaf.shape) == \
            tuple(node_i.shape), path
        assert node_t.dtype == node_i.dtype == torch.float32, path
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))
    assert len(tree_leaves(init)) == len(jax.tree.leaves(jp))


def test_bf16_params_convert_bit_exact():
    cfg = jllama.LlamaConfig.tiny()
    jp = jllama.llama_init(cfg, jax.random.PRNGKey(1))
    tp = _torch_params(jp)
    init = tllama.llama_init(tllama.LlamaConfig.tiny(), device="cpu")
    for got, want, fresh in zip(jax.tree.leaves(tp), jax.tree.leaves(jp),
                                jax.tree.leaves(init)):
        assert got.dtype == fresh.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 3, 64), dtype=np.float32)
    pos = rng.integers(0, 256, size=(2, 16))
    jcos, jsin = jrope.rope_table(64, 256, theta)
    tcos, tsin = trope.rope_table(64, 256, theta)
    assert tcos.shape == (256, 32) and tcos.dtype == torch.float32
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), **OP_TOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), **OP_TOL)
    for positions in (None, pos):
        want = jrope.apply_rope(
            jnp.asarray(x), jcos, jsin,
            None if positions is None else jnp.asarray(positions))
        got = trope.apply_rope(
            torch.from_numpy(x), tcos, tsin,
            None if positions is None else torch.from_numpy(positions))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    # bf16 in, bf16 out, rotated in fp32
    xb = torch.from_numpy(x).bfloat16()
    assert trope.apply_rope(xb, tcos, tsin).dtype == torch.bfloat16


def test_repeat_kv_matches_jax():
    """GQA repeats each kv head in a row (jnp.repeat), never in tile
    order: query head i reads kv head i // rep."""
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 5, 2, 64), dtype=np.float32)
    v = rng.standard_normal((2, 5, 2, 64), dtype=np.float32)
    jk, jv = jllama._repeat_kv(jnp.asarray(k), jnp.asarray(v), JCFG)
    tk, tv = tllama._repeat_kv(torch.from_numpy(k), torch.from_numpy(v),
                               TCFG)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_forward_and_loss_match_jax(params, monkeypatch):
    _pallas_fused(monkeypatch)
    jp, tp = params
    tok, tgt = _tokens(1, (2, 256)), _tokens(2, (2, 256))
    want = jllama.llama_forward(jp, jnp.asarray(tok, jnp.int32), JCFG)
    wl = jllama.llama_loss(jp, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(tgt, jnp.int32), JCFG)
    with torch.inference_mode():
        got = tllama.llama_forward(tp, torch.from_numpy(tok), TCFG)
        tl = tllama.llama_loss(tp, torch.from_numpy(tok),
                               torch.from_numpy(tgt), TCFG)
    assert got.shape == (2, 256, TCFG.padded_vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(tl), float(wl), **TOL)


@pytest.mark.parametrize("remat,vocab", [(False, 512), (True, 512),
                                         (False, 500)])
def test_loss_grad_matches_jax_fused_backward(params, monkeypatch, remat,
                                              vocab):
    """Every parameter's gradient of `llama_loss` against jax.grad of the
    JAX loss, whose attention backward is the single-pass Pallas kernel;
    the port's single-pass backward (its plain version on the CPU), with and
    without remat, and with a vocab (500) the padding has to mask."""
    _pallas_fused(monkeypatch)
    jcfg = dataclasses.replace(JCFG, vocab_size=vocab)
    tcfg = dataclasses.replace(TCFG, vocab_size=vocab)
    jp, tp = params
    tok, tgt = _tokens(5, (2, 256), vocab), _tokens(6, (2, 256), vocab)
    jloss, jgrads = jax.value_and_grad(jllama.llama_loss)(
        jp, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32), jcfg,
        remat)
    tp = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    leaves = tree_leaves(tp)
    loss = tllama.llama_loss(tp, torch.from_numpy(tok), torch.from_numpy(tgt),
                             tcfg, remat=remat)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = iter(torch.autograd.grad(loss, leaves))
    gtree = tree_map(lambda _: next(grads), tp)
    _assert_trees_close(gtree, jgrads, **TOL)
    # the padding columns of the LM head get no gradient
    assert not gtree["lm_head"][:, vocab:].any()


def test_cached_prefill_and_decode_match_jax(params):
    """Prefill and one-token decode through `llama_forward_cached`, then
    `llama_decode` at ragged per-slot positions, one token a slot and the
    verify form (k + 1 = 3 tokens a slot): logits and caches."""
    jp, tp = params
    b, t0 = 2, 10
    prompt = _tokens(3, (b, t0))
    jcache = jllama.init_kv_cache(JCFG, b)
    tcache = tllama.init_kv_cache(TCFG, b, device="cpu")
    assert tcache[0]["k"].shape == (b, 256, 2, 64)
    with torch.inference_mode():
        jl, jcache = jllama.llama_forward_cached(
            jp, jnp.asarray(prompt, jnp.int32), JCFG, jcache, 0)
        tl, tcache = tllama.llama_forward_cached(
            tp, torch.from_numpy(prompt), TCFG, tcache, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = _tokens(4, (b, 1))
        jl, jcache = jllama.llama_forward_cached(
            jp, jnp.asarray(nxt, jnp.int32), JCFG, jcache, t0)
        tl, tcache = tllama.llama_forward_cached(
            tp, torch.from_numpy(nxt), TCFG, tcache, t0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        # ragged positions: slot 1 decodes three rows behind slot 0
        pos = np.array([t0 + 1, t0 - 2])
        for i in range(2):
            tok = _tokens(10 + i, (b,))
            jl, jcache = jllama.llama_decode(
                jp, jnp.asarray(tok, jnp.int32), JCFG, jcache,
                jnp.asarray(pos + i, jnp.int32))
            tl, tcache = tllama.llama_decode(
                tp, torch.from_numpy(tok), TCFG, tcache,
                torch.from_numpy(pos + i))
            assert tl.shape == (b, TCFG.padded_vocab)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        verify = _tokens(12, (b, 3))
        jl, jcache = jllama.llama_decode(
            jp, jnp.asarray(verify, jnp.int32), JCFG, jcache,
            jnp.asarray(pos + 2, jnp.int32))
        tl, tcache = tllama.llama_decode(
            tp, torch.from_numpy(verify), TCFG, tcache,
            torch.from_numpy(pos + 2))
        assert tl.shape == (b, 3, TCFG.padded_vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for jb, tb in zip(jcache, tcache):
            for name in ("k", "v"):
                np.testing.assert_allclose(tb[name].numpy(),
                                           np.asarray(jb[name]), **TOL)
        # the mixed-tenant form: slot 0 on pool row 2, slot 1 on the null
        # row, the verify form again (rank 4, pool of 3 rows)
        rng = np.random.default_rng(5)
        jlora = {"idx": jnp.asarray([2, 0], jnp.int32),
                 "scale": jnp.asarray([0.0, 2.0, 3.0], jnp.float32)}
        for name, d_in, d_out in jlora_targets(JCFG):
            ab = [rng.standard_normal((3, JCFG.num_layers) + shape)
                  .astype(np.float32) * 0.05
                  for shape in ((d_in, 4), (4, d_out))]
            for x in ab:
                x[0] = 0.0
            jlora[name] = tuple(jnp.asarray(x) for x in ab)
        tlora = tree_map(lambda x: torch.from_numpy(np.array(x)), jlora)
        verify = _tokens(13, (b, 3))
        jl, jcache = jllama.llama_decode(
            jp, jnp.asarray(verify, jnp.int32), JCFG, jcache,
            jnp.asarray(pos + 5, jnp.int32), jlora)
        tl, tcache = tllama.llama_decode(
            tp, torch.from_numpy(verify), TCFG, tcache,
            torch.from_numpy(pos + 5), lora=tlora)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for jb, tb in zip(jcache, tcache):
            for name in ("k", "v"):
                np.testing.assert_allclose(tb[name].numpy(),
                                           np.asarray(jb[name]), **TOL)


PROMPTS = [[7, 3, 9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [42]]
BUDGETS = [9, 6, 12]


def _concurrently(engine, prompts, budgets):
    with cf.ThreadPoolExecutor(len(prompts)) as pool:
        futs = [pool.submit(engine.generate, p, n)
                for p, n in zip(prompts, budgets)]
        return [f.result(timeout=120) for f in futs]


def test_greedy_streams_match_jax(params):
    """A Llama tree reaches both of the port's serving entry points on the
    CPU (they once looked the device up under GPT-2's `wte`): greedy
    `generate()` equals the JAX `generate`, and the engine's concurrent
    streams equal the JAX engine's and the port's `generate()`."""
    jp, tp = params
    prompt = _tokens(7, (2, 5))
    want = jgenerate(jp, JCFG, jnp.asarray(prompt, jnp.int32),
                     max_new_tokens=8)
    got = generate(tp, TCFG, prompt, max_new_tokens=8)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jeng = JEngine(jp, JCFG, max_batch=2, prefix_cache=False, speculate_k=0)
    teng = ContinuousBatchingEngine(tp, TCFG, max_batch=2)
    try:
        assert teng.device.type == "cpu"
        want = _concurrently(jeng, PROMPTS, BUDGETS)
        got = _concurrently(teng, PROMPTS, BUDGETS)
    finally:
        jeng.stop()
        teng.stop()
    assert not teng._thread.is_alive()
    for p, n, w, g in zip(PROMPTS, BUDGETS, want, got):
        assert len(g) == n
        assert g == w, p
        assert g == generate(tp, TCFG, [p], max_new_tokens=n)[0].tolist()


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


def test_train_step_trajectory_matches_jax():
    """Five steps of the port's TrainStep + adamw(1e-3) on `llama_loss`
    (the fused backward) against the JAX TrainStep + optax.adamw(1e-3) on a
    one-device CPU mesh: every loss and the final parameters; then a JAX
    run of two steps carried into the port (`from_jax_params` +
    `from_jax_adamw_state`) continues for three more in step with JAX.
    TrainStep, adamw and the converters are model-agnostic: nothing of
    them changed for Llama."""
    def jloss_fn(p, b):
        return jllama.llama_loss(p, b["tokens"], b["targets"], JCFG)

    def tloss_fn(p, b):
        return tllama.llama_loss(p, b["tokens"], b["targets"], TCFG)

    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    specs = jllama.llama_partition_specs(JCFG)
    batches = _batches(5)

    jstep = JTrainStep(jloss_fn, optax.adamw(1e-3), mesh, specs)
    jstate, jlosses = _jax_steps(jstep, jstep.init_state(_jax_params(8)),
                                 batches)
    tstep = TrainStep(tloss_fn, adamw(1e-3), device="cpu")
    tstate = tstep.init_state(_torch_params(_jax_params(8)))
    # Adam's first update divides each gradient by its own magnitude (plus
    # eps 1e-8): where the first gradient is at the fp32 noise of its sum,
    # the two runs' first steps differ by a fraction of the learning rate.
    # Those elements are held to 5 steps of 1e-3, every other one to TOL.
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

    jstep2 = JTrainStep(jloss_fn, optax.adamw(1e-3), mesh, specs)
    jstate, _ = _jax_steps(jstep2, jstep2.init_state(_jax_params(8)),
                           batches[:2])
    carried = jax.tree.map(np.asarray, {"params": jstate["params"],
                                        "opt": jstate["opt_state"]})
    tstate = tstep.init_state(from_jax_params(carried["params"],
                                              device="cpu"))
    tstate["opt_state"] = from_jax_adamw_state(carried["opt"],
                                               tstate["params"],
                                               device="cpu")
    assert tstate["opt_state"]["count"] == 2
    jstate, jlosses = _jax_steps(jstep2, jstate, batches[2:])
    tstate, tlosses = _torch_steps(tstep, tstate, batches[2:])
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    _assert_trees_close(tstate["params"], jstate["params"], **TOL)
    _assert_trees_close(tstate["opt_state"]["nu"],
                        jstate["opt_state"][0].nu, **TOL)


@pytest.mark.parametrize("name", PRESETS)
def test_flops_match_jax(name):
    j = getattr(jllama.LlamaConfig, name)()
    t = getattr(tllama.LlamaConfig, name)()
    assert tflops.param_count(t) == jflops.param_count(j)
    for seq in (None, 2048):
        assert tflops.train_flops_per_token(t, seq) == \
            jflops.train_flops_per_token(j, seq)


def test_entry_points_without_device_raise_when_cuda_is_missing():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.llama_init(TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.init_kv_cache(TCFG, 1)
