"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function —
its Pallas kernel run in interpret mode, as tests/test_ops.py runs it —
and through the port's CPU path (the plain PyTorch version each kernel
wrapper takes for CPU tensors). The Hopper kernels themselves need the
card: `chip_smoke.py` holds each against its plain version there.
Tolerances follow tests/test_ops.py: forward fp32 atol 2e-5 / rtol 2e-4,
bf16 2e-2; gradients fp32 atol 1e-4 / rtol 1e-3, bf16 5e-2 (bf16 rounds
at different places in the two frameworks: the JAX kernels round P and
dS to bf16 before their products, the port's plain versions keep fp32).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import fused_ce as jce
from ray_tpu.ops import layers as jlayers
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import fused_ce as tce
from ray_tpu_torch.ops import layers as tlayers

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def _tol(dtype: str):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-4)


def _pair(arr: np.ndarray, dtype: str):
    jd, td = _DTYPES[dtype]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(arr).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk", [(True, 256, 256),
                                          (False, 256, 256),
                                          (True, 128, 256)])
def test_flash_attention_matches_jax(causal, tq, tk, dtype):
    rng = np.random.default_rng(0)
    b, h, d = 2, 2, 64
    q, k, v = (rng.standard_normal((b, t, h, d), dtype=np.float32)
               for t in (tq, tk, tk))
    (jq, tq_), (jk, tk_), (jv, tv_) = (_pair(a, dtype) for a in (q, k, v))
    want = jattn.flash_attention(jq, jk, jv, causal)
    got, lse = tattn.flash_attention(tq_, tk_, tv_, causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    ref = tattn.mha_reference(tq_, tk_, tv_, causal)
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    # the LSE the backward will read: against the JAX kernel's own
    jlse = jattn._flash_fwd_pallas(jq, jk, jv, causal, d ** -0.5, 128, 128,
                                   interpret=True)[1][..., 0]
    assert lse.shape == (b * h, tq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _f32(jlse), **_tol(dtype))


@pytest.mark.parametrize("n,d,v,vocab", [(256, 128, 640, 600),
                                         (128, 128, 768, 384)])
def test_linear_cross_entropy_matches_jax(n, d, v, vocab):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal((v, d), dtype=np.float32) * 0.1
    t = rng.integers(0, vocab, size=n)
    want = jce.linear_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t, jnp.int32), vocab)
    _, want_lse = jce._ce_reference(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t, jnp.int32), vocab)
    loss, lse = tce.linear_cross_entropy(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(t), vocab)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=1e-4, rtol=1e-4)


def test_fused_ce_gate_keeps_cpu_on_the_chunked_path():
    assert not tce.fused_ce_supported(2048, 768, 50304, torch.device("cpu"),
                                      torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 96), dtype=np.float32) * 3 + 1
    s = rng.standard_normal(96, dtype=np.float32)
    bias = rng.standard_normal(96, dtype=np.float32)
    (jx, tx), (js, ts), (jb, tb) = (_pair(a, dtype) for a in (x, s, bias))
    np.testing.assert_allclose(
        _f32(tlayers.layer_norm(tx, ts, tb)),
        _f32(jlayers.layer_norm(jx, js, jb)), **_tol(dtype))
    np.testing.assert_allclose(
        _f32(tlayers.rms_norm(tx, ts)), _f32(jlayers.rms_norm(jx, js)),
        **_tol(dtype))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers never run a plain version: the CPU path is chosen
    by the callers in ops/ for CPU tensors, and a wrapper handed one
    raises instead of computing."""
    from ray_tpu_torch import kernels

    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.flash_fwd(q, q, q, True, 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.flash_bwd_dq(q, q, q, q, lse, lse, True, 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.flash_bwd_dkv(q, q, q, q, lse, lse, True, 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.flash_bwd_fused(q, q, q, q, lse, lse, True, 0.125)
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.ce_fwd(x, x, torch.zeros(64, dtype=torch.long), 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.ce_dx(x, x, torch.zeros(64), 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.ce_dw(x, x, x, torch.zeros(64), 64)
    assert kernels.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0, "flash_bwd_fused": 0,
                                "ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}


def _grad_tol(dtype: str):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=1e-3)


def _attention_inputs(tq, tk, dtype, seed=3):
    rng = np.random.default_rng(seed)
    b, h, d = 2, 2, 64
    arrs = [rng.standard_normal((b, t, h, d), dtype=np.float32)
            for t in (tq, tk, tk, tq)]
    return [_pair(a, dtype) for a in arrs]  # q, k, v, dO


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk", [(True, 256, 256),
                                          (False, 256, 256),
                                          (True, 128, 384)])
def test_flash_bwd_reference_matches_jax_kernels(causal, tq, tk, dtype):
    """The port's plain backward against the JAX package's two backward
    Pallas kernels, from the same q, k, v, dO and the same forward O and
    LSE (the JAX forward kernel's)."""
    (jq, q), (jk, k), (jv, v), (jdo, do) = _attention_inputs(tq, tk, dtype)
    scale = 64 ** -0.5
    jo, jlse = jattn._flash_fwd_pallas(jq, jk, jv, causal, scale, 128, 128,
                                       interpret=True)
    want = jattn._flash_bwd_pallas(jq, jk, jv, jo, jlse, jdo, causal, scale,
                                   128, 128, interpret=True)
    o = torch.from_numpy(np.array(jo, np.float32)).to(q.dtype)
    lse = torch.from_numpy(np.array(jlse[..., 0], np.float32))
    got = tattn._flash_bwd_reference(q, k, v, o, lse, do, causal, scale)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == q.dtype and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=f"d{name}",
                                   **_grad_tol(dtype))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk", [(True, 256, 256),
                                          (False, 256, 256),
                                          (True, 128, 384)])
def test_flash_attention_grad_matches_jax(monkeypatch, causal, tq, tk, dtype,
                                          fused):
    """torch.autograd through the port's `flash_attention` (FlashAttention,
    its plain backward on the CPU) against jax.grad through the JAX one
    (its custom_vjp, the Pallas backward in interpret mode). With `fused`
    the port takes `fused_bwd=True` and JAX `RAY_TPU_FLASH_FUSED_BWD=1`:
    the single-pass Pallas kernel with 128-row blocks, so its dQ sums over
    several kv blocks."""
    blocks = (None, None)
    if fused:
        monkeypatch.setenv("RAY_TPU_FLASH_FUSED_BWD", "1")
        blocks = (128, 128)
    (jq, q), (jk, k), (jv, v), (jdo, do) = _attention_inputs(tq, tk, dtype)

    def jloss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, causal, None, *blocks)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = tattn.flash_attention(q, k, v, causal, fused_bwd=fused)
    assert not lse.requires_grad
    got = torch.autograd.grad(o, (q, k, v), do)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == q.dtype, name
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=f"d{name}",
                                   **_grad_tol(dtype))


@pytest.mark.parametrize("v,vocab", [(384, 380), (384, 384)])
def test_ce_bwd_reference_matches_jax_kernels(v, vocab):
    """The port's plain CE backward against the JAX `_ce_bwd_pallas` (dx
    and dW kernels in interpret mode plus its one-hot terms), fp32,
    padded and unpadded vocab."""
    rng = np.random.default_rng(4)
    n, d = 128, 128
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal((v, d), dtype=np.float32) * 0.1
    t = rng.integers(0, vocab, size=n)
    g = rng.standard_normal(n, dtype=np.float32) / n
    jx, jw, jt = jnp.asarray(x), jnp.asarray(w), jnp.asarray(t, jnp.int32)
    _, jlse = jce._ce_reference(jx, jw, jt, vocab)
    want = jce._ce_bwd_pallas(jx, jw, jt, jlse, jnp.asarray(g), vocab, 128,
                              jce._pick_block_v(v), interpret=True)
    got = tce._ce_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
        torch.from_numpy(np.array(jlse)), torch.from_numpy(g), vocab)
    for name, a, b in zip(("dx", "dw"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-3, err_msg=name)
    assert not got[1][vocab:].any()


@pytest.mark.parametrize("v,vocab", [(384, 380), (384, 384)])
def test_ce_bwd_products_match_jax_kernels(v, vocab):
    """The plain version of the two backward kernels' products, P W and
    P^T xg, against the JAX dx and dW kernels' own outputs, fp32: with
    g = 1 the one-hot terms `_ce_bwd_pallas` adds (-w[t] to dx, -x at
    the target rows of dW) are taken back out."""
    rng = np.random.default_rng(6)
    n, d = 128, 128
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal((v, d), dtype=np.float32) * 0.1
    t = rng.integers(0, vocab, size=n)
    jx, jw, jt = jnp.asarray(x), jnp.asarray(w), jnp.asarray(t, jnp.int32)
    _, jlse = jce._ce_reference(jx, jw, jt, vocab)
    jdx, jdw = jce._ce_bwd_pallas(jx, jw, jt, jlse, jnp.ones(n), vocab, 128,
                                  jce._pick_block_v(v), interpret=True)
    want_pw = np.asarray(jdx) + w[t]
    want_ptxg = np.asarray(jdw).copy()
    np.add.at(want_ptxg, t, x)
    xt = torch.from_numpy(x)
    pw, ptxg = tce._ce_bwd_products(
        xt, torch.from_numpy(w), xt, torch.from_numpy(np.array(jlse)), vocab)
    np.testing.assert_allclose(pw.numpy(), want_pw, atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(ptxg.numpy(), want_ptxg, atol=1e-5, rtol=1e-3)
    assert not ptxg[vocab:].any()


def test_linear_cross_entropy_grad_matches_autograd():
    """`LinearCrossEntropy`'s backward (the plain version on the CPU)
    equals autograd through the plain forward, padded vocab."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((96, 64), dtype=np.float32))
    w = torch.from_numpy(
        rng.standard_normal((256, 64), dtype=np.float32) * 0.1)
    t = torch.from_numpy(rng.integers(0, 250, size=96))
    g = torch.from_numpy(rng.standard_normal(96, dtype=np.float32))
    x.requires_grad_()
    w.requires_grad_()
    loss, lse = tce.linear_cross_entropy(x, w, t, 250)
    assert not lse.requires_grad
    got = torch.autograd.grad(loss, (x, w), g)
    want = torch.autograd.grad(tce._ce_reference(x, w, t, 250)[0], (x, w), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)
