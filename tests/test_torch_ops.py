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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,vocab", [(640, 600), (384, 384)])
def test_linear_cross_entropy_matches_jax_kernel(v, vocab, dtype):
    """The port's CE forward on the CPU against the JAX Pallas forward
    kernel itself (`_ce_fwd_pallas` in interpret mode, blocks of 128
    rows and 128 vocab columns), padded and unpadded vocab, fp32 and bf16
    inputs (both sum the products in fp32)."""
    rng = np.random.default_rng(7)
    n, d = 256, 128
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal((v, d), dtype=np.float32) * 0.1
    t = rng.integers(0, vocab, size=n)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    want_loss, want_lse = jce._ce_fwd_pallas(
        jx, jw, jnp.asarray(t, jnp.int32), vocab, 128, 128, interpret=True)
    loss, lse = tce.linear_cross_entropy(tx, tw, torch.from_numpy(t), vocab)
    np.testing.assert_allclose(loss.numpy(), _f32(want_loss), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), _f32(want_lse), atol=1e-4,
                               rtol=1e-4)


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


_Q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
_LSE = torch.zeros(2, 64)
_X = torch.zeros(64, 64, dtype=torch.bfloat16)
_WRAPPER_CALLS = {
    "flash_fwd": lambda k: k.flash_fwd(_Q, _Q, _Q, True, 0.125),
    "flash_bwd_dq": lambda k: k.flash_bwd_dq(_Q, _Q, _Q, _Q, _LSE, _LSE,
                                             True, 0.125),
    "flash_bwd_dkv": lambda k: k.flash_bwd_dkv(_Q, _Q, _Q, _Q, _LSE, _LSE,
                                               True, 0.125),
    "flash_bwd_fused": lambda k: k.flash_bwd_fused(_Q, _Q, _Q, _Q, _LSE,
                                                   _LSE, True, 0.125),
    "ce_fwd": lambda k: k.ce_fwd(_X, _X, torch.zeros(64, dtype=torch.long),
                                 64),
    "ce_bwd": lambda k: k.ce_bwd(_X, _X, _X, torch.zeros(64), 64),
}


@pytest.mark.parametrize("wrapper", sorted(_WRAPPER_CALLS))
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The wrappers never run a plain version: the CPU path is chosen
    by the callers in ops/ for CPU tensors, and a wrapper handed one
    raises instead of computing."""
    from ray_tpu_torch import kernels

    with pytest.raises(ValueError, match="CUDA tensors"):
        _WRAPPER_CALLS[wrapper](kernels)
    assert kernels.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0, "flash_bwd_fused": 0,
                                "ce_fwd": 0, "ce_probs": 0, "ce_dx": 0,
                                "ce_dw": 0}


@pytest.mark.parametrize("err, what", [
    (1, "CUDA error 1"),
    (10001, "a TMA tensor map was refused, driver error 1")])
def test_launch_errors_raise_and_are_not_counted(monkeypatch, err, what):
    """A wrapper raises on the code its kernel's entry point returned: a
    CUDA error, or 10000 + the driver's error where a TMA tensor map of
    the inputs was refused. Only a launch counts."""
    from ray_tpu_torch import kernels

    monkeypatch.setitem(kernels.LAUNCHES, "flash_fwd", 0)
    with pytest.raises(RuntimeError, match=what):
        kernels._launched("flash_fwd", err)
    assert kernels.LAUNCHES["flash_fwd"] == 0
    kernels._launched("flash_fwd", 0)
    assert kernels.LAUNCHES["flash_fwd"] == 1


class _CudaLike:
    """What `kernels.flash_takes` reads of a tensor, as a CUDA tensor
    would show it (this host has no card to make one on)."""

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("q,k,causal,takes", [
    ((2, 128, 4, 64), (2, 128, 4, 64), True, True),
    ((2, 64, 4, 128), (2, 256, 4, 128), True, True),     # tq < tk
    ((2, 256, 4, 64), (2, 128, 4, 64), False, True),     # tq > tk, full
    ((2, 128, 4, 32), (2, 128, 4, 32), True, False),     # head_dim 32
    ((2, 256, 4, 64), (2, 128, 4, 64), True, False),     # causal tq > tk
    ((2, 128, 64), (2, 128, 64), True, False),           # not 4-D
    ((2, 128, 4, 64), (2, 128, 2, 64), True, False),     # heads differ
    ((2, 0, 4, 64), (2, 128, 4, 64), True, False),       # empty
])
def test_flash_takes(q, k, causal, takes):
    """The attention kernels' predicate: bf16 CUDA tensors with head_dim
    64 or 128 and not causal with tq > tk; everything else is refused
    without raising, fp32 and CPU tensors included."""
    from ray_tpu_torch import kernels

    qs, ks = _CudaLike(q), _CudaLike(k)
    assert kernels.flash_takes(qs, ks, ks, causal) is takes
    wide = _CudaLike(q, torch.float32)
    assert kernels.flash_takes(wide, _CudaLike(k, torch.float32),
                               _CudaLike(k, torch.float32), causal) is False
    cpu_q, cpu_k = (torch.zeros(s, dtype=torch.bfloat16) for s in (q, k))
    assert kernels.flash_takes(cpu_q, cpu_k, cpu_k, causal) is False


@pytest.mark.parametrize("causal,tq,tk", [(True, 128, 128),
                                          (True, 128, 64),
                                          (False, 64, 128)])
def test_refused_attention_route_matches_jax(causal, tq, tk):
    """What `flash_attention` runs for CUDA inputs the kernels refuse
    (`_plain_attention`, mha_reference under autograd) against the JAX
    `flash_attention` at head_dim 32, which its `_shapes_ok` sends to the
    JAX reference: O, the LSE and the gradients, fp32. Causal tq > tk
    gives the mean of V to the rows that see no key, as JAX does."""
    (jq, q), (jk, k), (jv, v), (jdo, do) = _attention_inputs(
        tq, tk, "float32", d=32)

    def jloss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, causal)
        return jnp.sum(o * jdo)

    want = jattn.flash_attention(jq, jk, jv, causal)
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = tattn._plain_attention(q, k, v, causal, 32 ** -0.5)
    np.testing.assert_allclose(_f32(o.detach()), _f32(want), **_tol(
        "float32"))
    logits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * 32 ** -0.5
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((tq, tk), bool), tk - tq),
                           logits, -1e30)
    want_lse = jax.nn.logsumexp(logits, axis=-1).reshape(-1, tq)
    assert not lse.requires_grad and lse.shape == (2 * 2, tq)
    np.testing.assert_allclose(lse.numpy(), _f32(want_lse),
                               **_tol("float32"))
    if causal and tq > tk:  # the first tq - tk rows see no key
        np.testing.assert_allclose(
            _f32(o.detach()[:, :tq - tk]),
            np.broadcast_to(_f32(v.detach()).mean(1, keepdims=True),
                            (2, tq - tk, 2, 32)), atol=1e-6)
    got = torch.autograd.grad(o, (q, k, v), do)
    for name, g, w in zip("qkv", got, want_grads):
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=f"d{name}",
                                   **_grad_tol("float32"))
    # CPU tensors take FlashAttention's plain versions: no plain-route call
    calls = tattn.PLAIN_CALLS["attention"]
    tattn.flash_attention(q.detach(), k.detach(), v.detach(), causal)
    assert tattn.PLAIN_CALLS["attention"] == calls


def _grad_tol(dtype: str):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=1e-3)


def _attention_inputs(tq, tk, dtype, seed=3, d=64):
    rng = np.random.default_rng(seed)
    b, h = 2, 2
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


_CHUNKINGS = [(384, 380, 128),   # chunks divide V, padding in the last
              (384, 380, 256),   # chunks of 256 and 128
              (384, 250, 128)]   # padding from inside a chunk to the end


@pytest.mark.parametrize("v,vocab,vc,dtype", [
    (384, 380, None, "float32"), (384, 384, None, "float32"),
    *((*c, "float32") for c in _CHUNKINGS),
    *((*c, "bfloat16") for c in _CHUNKINGS)])
def test_ce_bwd_products_match_jax_kernels(v, vocab, vc, dtype):
    """The plain versions of the backward's products, P W and P^T xg —
    whole (`_ce_bwd_products`, vc None) or composed chunk by chunk as
    `kernels.ce_bwd` composes its kernels (`_ce_probs_reference`, then the
    fp32 products: `_ce_bwd_chunked`) — against the JAX dx and dW kernels'
    own outputs: with g = 1 the one-hot terms `_ce_bwd_pallas` adds (-w[t]
    to dx, -x at the target rows of dW) are taken back out. fp32, and the
    chunked composition in bf16 too, where both round P to bf16 before the
    products."""
    rng = np.random.default_rng(6)
    n, d = 128, 128
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal((v, d), dtype=np.float32) * 0.1
    t = rng.integers(0, vocab, size=n)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    jt = jnp.asarray(t, jnp.int32)
    _, jlse = jce._ce_reference(jx, jw, jt, vocab)
    jdx, jdw = jce._ce_bwd_pallas(jx, jw, jt, jlse, jnp.ones(n), vocab, 128,
                                  jce._pick_block_v(v), interpret=True)
    xf, wf = _f32(jx), _f32(jw)
    want_pw = _f32(jdx) + wf[t]
    want_ptxg = _f32(jdw).copy()
    np.add.at(want_ptxg, t, xf)
    lse = torch.from_numpy(np.array(jlse, np.float32))
    if vc is None:
        pw, ptxg = tce._ce_bwd_products(tx, tw, tx, lse, vocab)
    else:
        pw, ptxg = tce._ce_bwd_chunked(tx, tw, tx, lse, vocab, vc)
    tol = dict(atol=1e-5, rtol=2e-4) if dtype == "float32" \
        else _tol(dtype)
    np.testing.assert_allclose(pw.numpy(), want_pw, **tol)
    np.testing.assert_allclose(ptxg.numpy(), want_ptxg, **tol)
    assert not ptxg[vocab:].any()


@pytest.mark.parametrize("n,v", [(8192, 50304), (2048, 50304), (100, 640),
                                 (20000, 13056), (1, 50257), (2 ** 19, 384),
                                 (2 ** 20, 50304)])
def test_ce_chunk_width(n, v):
    """The CE backward's chunk planner: a multiple of 128, at least 128,
    at most V rounded up to 128, and the largest whose bf16 scratch [n, Vc]
    fits 128 MiB (where 128 columns fit at all); GPT-2's training shape
    walks V = 50304 in 7 chunks of 8192."""
    from ray_tpu_torch import kernels

    vc = kernels.ce_chunk_width(n, v)
    top = -(-v // 128) * 128
    assert vc % 128 == 0 and 128 <= vc <= top
    if 2 * n * 128 <= kernels.CE_SCRATCH_BYTES:
        assert 2 * n * vc <= kernels.CE_SCRATCH_BYTES
        assert vc == top or 2 * n * (vc + 128) > kernels.CE_SCRATCH_BYTES
    else:
        assert vc == 128
    if (n, v) == (8192, 50304):
        assert vc == 8192 and -(-v // vc) == 7


@pytest.mark.parametrize("n", [100, 2048, 8192])
@pytest.mark.parametrize("v", [640, 50304])
def test_ce_fwd_partition(n, v):
    """ce_fwd's grid on an H100's 132 SMs covers each 256-column vocab
    tile of each 128-row tile exactly once, the ragged last tile too,
    with no empty split and no more CTAs than SMs; GPT-2's LM head at
    both its N runs 128 CTAs."""
    from ray_tpu_torch import kernels

    sms = 132
    splits, per = kernels.ce_fwd_partition(n, v, sms)
    row_tiles = -(-n // kernels.CE_FWD_ROWS)
    vocab_tiles = -(-v // kernels.CE_FWD_COLS)
    covered = np.zeros((row_tiles, vocab_tiles), dtype=int)
    for r in range(row_tiles):        # the kernel's grid: (row tile,
        for s in range(splits):       # split), tiles [s per, (s+1) per)
            tiles = range(s * per, min(vocab_tiles, (s + 1) * per))
            assert len(tiles) > 0
            covered[r, list(tiles)] += 1
    assert (covered == 1).all()
    last = (vocab_tiles - 1) * kernels.CE_FWD_COLS
    assert last < v <= last + kernels.CE_FWD_COLS
    assert row_tiles * splits <= max(sms, row_tiles)
    if v == 50304 and n in (2048, 8192):
        assert row_tiles * splits == 128


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
