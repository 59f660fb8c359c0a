"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function —
its Pallas kernel run in interpret mode, as tests/test_ops.py runs it —
and through the port's CPU path (the plain PyTorch version each kernel
wrapper takes for CPU tensors). The Hopper kernels themselves need the
card: `chip_smoke.py` holds each against its plain version there.
Tolerances follow tests/test_ops.py: fp32 atol 2e-5 / rtol 2e-4, bf16
2e-2 (bf16 rounds at different places in the two frameworks).
"""
from __future__ import annotations

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
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.flash_fwd(q, q, q, True, 0.125)
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.ce_fwd(x, x, torch.zeros(64, dtype=torch.long), 64)
    assert kernels.LAUNCHES == {"flash_fwd": 0, "ce_fwd": 0}
