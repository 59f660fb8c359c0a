"""Parity of the port's mixture-of-experts layer and model
(ray_tpu_torch.ops.moe, ray_tpu_torch.models.moe_transformer, the MoE
branch of observability.flops) with the JAX package's, on the CPU.

The same numpy inputs from a seed go to both packages; JAX parameters
cross over with `from_jax_params`. The model twin is `MoEConfig.tiny()`
at fp32 with d_model 256 and 4 heads (head_dim 64, T 256), so the JAX
model's `flash_attention` runs its Pallas kernels (interpret mode,
128-row blocks, the default two-pass backward) rather than its plain
fallback. Tolerances as tests/test_ops.py:39-41 for single ops (fp32
atol 2e-5 / rtol 2e-4, bf16 2e-2) and 1e-4 for a whole model's logits,
losses and gradients (tests/test_torch_llama.py); routing decisions
(dispatch) exactly. The expert-parallel form (ep 4), ring and Ulysses
attention run on the 4-rank gang of tests/test_torch_parallel_gang.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe_transformer as jmoe
from ray_tpu.observability import flops as jflops
from ray_tpu.ops import attention as jattn
from ray_tpu.ops import moe as jops
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe_transformer as tmoe
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.observability import flops as tflops
from ray_tpu_torch.ops import moe as tops
from ray_tpu_torch.tree import tree_leaves, tree_map

_TWIN = dict(d_model=256, num_heads=4, num_kv_heads=2, max_seq_len=256)
JCFG = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=jnp.float32,
                           **_TWIN)
TCFG = dataclasses.replace(tmoe.MoEConfig.tiny(), dtype=torch.float32,
                           **_TWIN)
TOL = dict(atol=1e-4, rtol=1e-4)
OP_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
PRESETS = ["tiny", "mixtral_8x7b"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _tokens(seed, shape, vocab=JCFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _pallas(mp: pytest.MonkeyPatch) -> None:
    """JAX attention through its Pallas kernels in interpret mode, 128-row
    blocks, the default two-pass backward."""
    mp.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    mp.delenv("RAY_TPU_FLASH_FUSED_BWD", raising=False)
    mp.setattr(jattn, "DEFAULT_BLOCK_Q", 128)
    mp.setattr(jattn, "DEFAULT_BLOCK_K", 128)


@pytest.fixture(scope="module")
def params():
    jp = jmoe.moe_init(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("name", PRESETS + ["default"])
def test_config_matches_jax(name):
    j = jmoe.MoEConfig() if name == "default" else \
        getattr(jmoe.MoEConfig, name)()
    t = tmoe.MoEConfig() if name == "default" else \
        getattr(tmoe.MoEConfig, name)()
    fields = ("vocab_size", "max_seq_len", "num_layers", "num_heads",
              "num_kv_heads", "d_model", "d_ff", "num_experts", "top_k",
              "capacity_factor", "aux_loss_coeff", "rope_theta",
              "vocab_pad_multiple", "head_dim", "padded_vocab")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    tl, jl = t.as_llama(), j.as_llama()
    assert isinstance(tl, tllama.LlamaConfig)
    assert dataclasses.asdict(tl) == {**dataclasses.asdict(jl),
                                      "dtype": torch.bfloat16}


def test_presets_are_consistent():
    """tests/test_models.py's MoE part."""
    m = tmoe.MoEConfig.mixtral_8x7b()
    assert m.num_experts == 8 and m.top_k == 2
    assert m.d_model % m.num_heads == 0
    assert m.num_heads % m.num_kv_heads == 0
    assert (m.d_model, m.num_heads, m.num_kv_heads, m.head_dim, m.d_ff,
            m.vocab_size, m.rope_theta) == (4096, 32, 8, 128, 14336, 32000,
                                            1e6)


def test_params_keep_the_jax_layout(params):
    """moe_init gives the JAX tree's keys, shapes and dtype, and
    from_jax_params carries a JAX moe_init tree over unchanged."""
    jp, tp = params
    init = tmoe.moe_init(TCFG, torch.Generator().manual_seed(0),
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
    moe = init["blocks"][0]["moe"]
    assert tuple(moe["w_in"].shape) == (4, 256, 256)
    assert tuple(moe["gate_w"].shape) == (256, 4)


# --------------------------------------------------------------- routing

def _logits(case):
    rng = np.random.default_rng(7)
    if case == "ties":
        # three values for 8 experts: most rows tie among their top 2
        return rng.integers(0, 3, (64, 8)).astype(np.float32)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    if case == "bf16":
        # bf16 router logits, as the model computes them: rounded to 3
        # bits of mantissa here, so equal values are common
        return np.round(x * 4) / 4
    return x


@pytest.mark.parametrize("case,k,cap", [
    ("random", 2, 20), ("random", 1, 10), ("drops", 2, 3),
    ("ties", 2, 20), ("ties", 1, 4), ("bf16", 2, 20)])
def test_top_k_routing_matches_jax(case, k, cap):
    """_top_k_routing's dispatch exactly and combine within the op
    tolerance: GShard queue positions (choices-major, token-minor),
    capacity drops, and among tied probabilities the lower expert index
    first, as jax.lax.top_k orders them."""
    x = _logits("random" if case == "drops" else case)
    dt = torch.bfloat16 if case == "bf16" else torch.float32
    jdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    jd, jc = jops._top_k_routing(jnp.asarray(x, jdt), k, 8, cap)
    td, tc = tops._top_k_routing(torch.from_numpy(x).to(dt), k, 8, cap)
    assert td.shape == (64, 8, cap) and td.dtype == torch.float32
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **OP_TOL)
    if case == "ties":
        probs = torch.softmax(torch.from_numpy(x), -1)
        assert (probs.sort(-1, descending=True).values[:, k - 1:k + 1]
                .diff(dim=-1) == 0).any(), "no tie at the k-th place"


def test_top_k_stable_takes_the_lower_index_among_ties():
    probs = torch.tensor([[0.3, 0.3, 0.3, 0.1], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = tops.top_k_stable(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ---------------------------------------------------------------- moe_ffn

def _ffn_inputs(seed, t=32, d=16, f=32, e=8, shape=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape or (t, d)).astype(np.float32)
    return [x, (rng.standard_normal((d, e)) * 0.5).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32),
            (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32)]


FFN_CASES = {
    "gelu": dict(),
    "silu": dict(activation="silu"),
    "batched_3d": dict(shape=(2, 16, 16)),
    "drops": dict(capacity_factor=0.5),
    "top1": dict(top_k=1),
}


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    """moe_ffn's output, router logits and the gradients of x, gate_w,
    w_in and w_out against jax.grad, fp32: the default tanh GELU and
    SiLU, a [B, S, D] input, capacity drops, top 1."""
    kw = dict(FFN_CASES[case])
    shape = kw.pop("shape", None)
    act = kw.pop("activation", None)
    args = _ffn_inputs(11, shape=shape)
    w = np.random.default_rng(12).standard_normal(
        args[0].shape).astype(np.float32)
    jkw = dict(kw, **({"activation": jax.nn.silu} if act else {}))
    tkw = dict(kw, **({"activation": torch.nn.functional.silu}
                      if act else {}))

    def jloss(*a):
        y, lg = jops.moe_ffn(*a, return_router_logits=True, **jkw)
        return jnp.sum(y * w) + jnp.sum(lg ** 2), (y, lg)

    (_, (jy, jlg)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    ty, tlg = tops.moe_ffn(*ts, return_router_logits=True, **tkw)
    tg = torch.autograd.grad((ty * torch.from_numpy(w)).sum()
                             + (tlg ** 2).sum(), ts)
    assert ty.shape == args[0].shape
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **OP_TOL)
    np.testing.assert_allclose(_np(tlg), np.asarray(jlg), **OP_TOL)
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(_np(g), np.asarray(want), **OP_TOL)


def test_moe_ffn_bf16_matches_jax():
    """bf16 in, bf16 out: fp32 dispatch and combine, bf16 expert
    products, within the bf16 tolerance."""
    args = _ffn_inputs(13)
    jy = jops.moe_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    ty = tops.moe_ffn(*(torch.from_numpy(a).bfloat16() for a in args))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               **BF16_TOL)


def test_moe_routes_to_best_expert():
    """tests/test_parallel.py:116: a gate that sends token j to expert j
    gives that expert's FFN (tanh GELU) of the token."""
    d, f, e = 4, 8, 4
    rng = np.random.default_rng(3)
    w_in = torch.from_numpy((rng.standard_normal((e, d, f)) * 0.3)
                            .astype(np.float32))
    w_out = torch.from_numpy((rng.standard_normal((e, f, d)) * 0.3)
                             .astype(np.float32))
    x = torch.eye(e, d)
    gate_w = torch.eye(d, e) * 50.0
    out = tops.moe_ffn(x, gate_w, w_in, w_out, top_k=1, capacity_factor=4.0)
    for j in range(e):
        ref = torch.nn.functional.gelu(x[j] @ w_in[j],
                                       approximate="tanh") @ w_out[j]
        np.testing.assert_allclose(out[j].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------- load-balancing loss

@pytest.mark.parametrize("k", [1, 2])
def test_load_balancing_loss_matches_jax(k):
    """Value and gradient in the logits, [B, T, E] logits."""
    x = np.random.default_rng(5).standard_normal((2, 32, 8)) \
        .astype(np.float32)
    jv, jg = jax.value_and_grad(jops.load_balancing_loss)(jnp.asarray(x), k)
    t = torch.from_numpy(x).requires_grad_()
    tv = tops.load_balancing_loss(t, k)
    g, = torch.autograd.grad(tv, [t])
    np.testing.assert_allclose(float(tv.detach()), float(jv), **OP_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **OP_TOL)


def test_load_balancing_loss_uniform_is_one():
    """tests/test_parallel.py: a uniform router gives exactly 1."""
    lb = tops.load_balancing_loss(torch.zeros(64, 8), top_k=8)
    assert abs(float(lb) - 1.0) < 1e-5


# ------------------------------------------------------------------ model

def test_moe_forward_matches_jax(params, monkeypatch):
    """Logits and every layer's router logits, the JAX attention through
    its Pallas kernels (interpret mode)."""
    _pallas(monkeypatch)
    jp, tp = params
    tok = _tokens(1, (2, 256))
    jl, jr = jmoe.moe_forward(jp, jnp.asarray(tok, jnp.int32), JCFG,
                              return_router_logits=True)
    with torch.inference_mode():
        tl, tr = tmoe.moe_forward(tp, torch.from_numpy(tok), TCFG,
                                  return_router_logits=True)
        plain = tmoe.moe_forward(tp, torch.from_numpy(tok), TCFG)
    assert tl.shape == (2, 256, TCFG.padded_vocab)
    assert tl.dtype == torch.float32
    np.testing.assert_array_equal(plain.numpy(), tl.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert len(tr) == len(jr) == TCFG.num_layers
    for got, want in zip(tr, jr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("remat,vocab", [(False, 512), (True, 512),
                                         (False, 500)])
def test_moe_loss_grad_matches_jax(params, monkeypatch, remat, vocab):
    """moe_loss and every parameter's gradient against jax.grad of the
    JAX loss (the two-pass Pallas backward in interpret mode), with and
    without remat, and with a vocab (500) the padding has to mask."""
    _pallas(monkeypatch)
    jcfg = dataclasses.replace(JCFG, vocab_size=vocab)
    tcfg = dataclasses.replace(TCFG, vocab_size=vocab)
    jp, tp = params
    tok, tgt = _tokens(5, (2, 256), vocab), _tokens(6, (2, 256), vocab)
    jloss, jgrads = jax.value_and_grad(jmoe.moe_loss)(
        jp, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32), jcfg,
        remat)
    tp = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    loss = tmoe.moe_loss(tp, torch.from_numpy(tok), torch.from_numpy(tgt),
                         tcfg, remat=remat)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = iter(torch.autograd.grad(loss, tree_leaves(tp)))
    gtree = tree_map(lambda _: next(grads), tp)
    got, want = jax.tree.leaves(gtree), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=f"leaf {i}",
                                   **TOL)
    assert not gtree["lm_head"][:, vocab:].any()


def test_moe_forward_and_router():
    """tests/test_models.py:90 on the port: shapes of the logits and of
    each layer's router logits, bf16 tiny config."""
    cfg = tmoe.MoEConfig.tiny()
    p = tmoe.moe_init(cfg, device="cpu")
    logits, router = tmoe.moe_forward(p, torch.zeros(2, 16, dtype=torch.long),
                                      cfg, return_router_logits=True)
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert len(router) == cfg.num_layers
    assert router[0].shape == (2 * 16, cfg.num_experts)


def test_moe_aux_loss_positive():
    """tests/test_models.py:116 on the port: the balancing term adds."""
    cfg = tmoe.MoEConfig.tiny()
    p = tmoe.moe_init(cfg, device="cpu")
    tok, tgt = (torch.from_numpy(_tokens(s, (2, 16), cfg.vocab_size))
                for s in (8, 9))
    with_aux = float(tmoe.moe_loss(p, tok, tgt, cfg))
    no_aux = float(tmoe.moe_loss(p, tok, tgt, dataclasses.replace(
        cfg, aux_loss_coeff=0.0)))
    assert with_aux > no_aux


# ------------------------------------------------------------------ flops

@pytest.mark.parametrize("name", PRESETS + ["default"])
def test_flops_match_jax(name):
    """The MoE branch of param_count is JAX's as written (top_k * 3 d
    d_ff for the active experts), and so are the training FLOPs."""
    j = jmoe.MoEConfig() if name == "default" else \
        getattr(jmoe.MoEConfig, name)()
    t = tmoe.MoEConfig() if name == "default" else \
        getattr(tmoe.MoEConfig, name)()
    assert tflops.param_count(t) == jflops.param_count(j)
    for seq in (None, 4096):
        assert tflops.train_flops_per_token(t, seq) == \
            jflops.train_flops_per_token(j, seq)


def test_analytic_flops_llama_and_moe():
    """tests/test_observability.py:51 on the port: top 2 of 4 experts
    cost as much as a dense MLP of twice the width."""
    assert tflops.train_flops_per_token(tllama.LlamaConfig.tiny()) > 0
    moe = tmoe.MoEConfig(num_layers=2, num_heads=4, num_kv_heads=2,
                         d_model=128, d_ff=256, vocab_size=512,
                         max_seq_len=128, num_experts=4, top_k=2)
    dense_like = tllama.LlamaConfig(num_layers=2, num_heads=4,
                                    num_kv_heads=2, d_model=128,
                                    d_ff=2 * 256, vocab_size=512,
                                    max_seq_len=128)
    assert tflops.param_count(moe) == tflops.param_count(dense_like)


def test_params_size_counts_every_expert(params):
    """params_size is the total count (JAX's), which for an MoE tree is
    more than the active count param_count gives."""
    jp, tp = params
    assert tflops.params_size(tp) == jflops.params_size(jp)
    assert tflops.params_size(tp) > tflops.param_count(TCFG)


def test_entry_points_without_device_raise_when_cuda_is_missing():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmoe.moe_init(TCFG)
