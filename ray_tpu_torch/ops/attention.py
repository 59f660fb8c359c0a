"""Flash attention, forward and backward (port of ray_tpu/ops/attention.py).

`flash_attention` is differentiable. Which route an input takes:
- CUDA tensors the kernels take (`kernels.flash_takes`: bf16, head_dim
  64 or 128, not causal with tq > tk) go through `FlashAttention`, the
  port's twin of the JAX `custom_vjp`: the forward runs the hand-written
  Hopper kernel `csrc/flash_fwd.cu`, and the backward either the two
  kernels of `csrc/flash_bwd.cu` (dQ, then dK/dV, as the JAX package's
  default two-pass backward) or, with `fused_bwd=True`, its single-pass
  kernel (dQ, dK, dV from one pass per kv tile; the port's stand-in for
  the JAX package's `RAY_TPU_FLASH_FUSED_BWD=1`). Both recompute P from
  the saved LSE.
- CUDA tensors the kernels refuse (fp32, head_dim 32, causal tq > tk)
  go through the plain `mha_reference` under autograd, as the JAX
  package takes its XLA reference where `_shapes_ok` fails.
- CPU tensors go through `FlashAttention` with the plain versions below
  in both directions.
Layout [B, T, H, D]; a causal mask is aligned to the END of the kv
sequence (query i sees keys j <= i + tk - tq), as in the JAX reference,
so a causal query row that sees no key (tq > tk) gets the mean of V.
`cached_attention` is the serving path's attention over a KV cache,
plain PyTorch as the JAX package's einsums are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

_NEG_INF = -1e30
# flash_attention calls on CUDA tensors the kernels refuse, which took the
# plain route, since it was last set to 0: no kernel counts them, so this
# makes that route visible (the main paths expect none)
PLAIN_CALLS = {"attention": 0}


def _masked_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   sm_scale: float) -> torch.Tensor:
    """fp32 scaled scores [B, H, Tq, Tk], masked entries at -1e30."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    return logits


def _attend(logits: torch.Tensor, v: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain multi-head attention. q, k, v: [B, T, H, D]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _attend(_masked_logits(q, k, causal, sm_scale), v, q.dtype)


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, sm_scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, natural-log LSE [B*H, Tq] fp32) in plain PyTorch: O as
    `mha_reference` (differentiable), the LSE detached."""
    b, tq, h, _ = q.shape
    logits = _masked_logits(q, k, causal, sm_scale)
    lse = torch.logsumexp(logits.detach(), dim=-1).reshape(b * h, tq)
    return _attend(logits, v, q.dtype), lse


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, sm_scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, natural-log LSE [B*H, Tq] fp32): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.is_cuda:
        return kernels.flash_fwd(q, k, v, causal, sm_scale)
    return _plain_attention(q, k, v, causal, sm_scale)


def softmax_correction(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, [B*H, Tq] contiguous: the row term the
    backward kernels read beside the LSE."""
    b, tq, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2) \
        .reshape(b * h, tq).contiguous()


def _flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor,
                         do: torch.Tensor, causal: bool, sm_scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain version of the backward kernels, the two-pass pair and the
    single-pass (fused) one alike, since all compute the same function:
    (dQ, dK, dV) in the input dtypes, from the forward's O and
    natural-log LSE [B*H, Tq].
    D = rowsum(dO * O), P = exp(S - LSE), dS = P * (dO V^T - D),
    dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO, all in fp32."""
    b, tq, h, _ = q.shape
    p = torch.exp(_masked_logits(q, k, causal, sm_scale)
                  - lse.reshape(b, h, tq, 1))
    dof = do.float()
    dcor = softmax_correction(o, do).reshape(b, h, tq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - dcor[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: saves q, k, v, O and the LSE
    (which it also returns, non-differentiable) and recomputes P from
    them. On CUDA tensors the backward computes D = rowsum(dO * O) in
    PyTorch and launches `flash_bwd_dq` and `flash_bwd_dkv`, or
    `flash_bwd_fused` alone when `fused_bwd`; on CPU tensors it runs
    `_flash_bwd_reference`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float,
                fused_bwd: bool = False):
        o, lse = _flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.fused_bwd = causal, sm_scale, fused_bwd
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.sm_scale
        do = do.contiguous()
        if not q.is_cuda:
            dq, dk, dv = _flash_bwd_reference(q, k, v, o, lse, do, causal,
                                              scale)
            return dq, dk, dv, None, None, None
        dcor = softmax_correction(o, do)
        if ctx.fused_bwd:
            dq, dk, dv = kernels.flash_bwd_fused(q, k, v, do, lse, dcor,
                                                 causal, scale)
            # the kernel sums dQ in fp32; cast outside, as JAX does
            return dq.to(q.dtype), dk, dv, None, None, None
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, dcor, causal, scale)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, dcor, causal, scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    fused_bwd: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention: (O [B, Tq, H, D], natural-log LSE [B*H, Tq] fp32,
    non-differentiable), differentiable in q, k and v. The Hopper kernels
    for CUDA tensors they take (`kernels.flash_takes`); `mha_reference`
    under autograd for CUDA tensors they refuse, as JAX falls back to its
    reference off `_shapes_ok`; the plain versions inside `FlashAttention`
    for CPU tensors. `fused_bwd` picks the single-pass backward kernel over
    the two-pass pair (the same function; off by default, as in JAX)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if q.is_cuda and not kernels.flash_takes(q, k, v, causal):
        PLAIN_CALLS["attention"] += 1
        return _plain_attention(q, k, v, causal, scale)
    return FlashAttention.apply(q, k, v, causal, scale, fused_bwd)


def cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """q [B, t, H, hd] at `positions` ([B, t] or [t]) attends every row of
    the cache ck, cv [B, S, H_kv, hd] at or before its own position; each
    group of H / H_kv query heads in a row reads one kv head (grouped-query
    attention; H_kv = H is plain multi-head). fp32 scores over the whole
    cache window (the JAX package's reduction shapes), probabilities in
    q's dtype. Returns [B, t, H * hd]."""
    b, t, h, hd = q.shape
    kv_heads = ck.shape[2]
    rep = h // kv_heads
    qg = q.reshape(b, t, kv_heads, rep, hd)
    scores = torch.einsum("btkrd,bskd->bkrts", qg.float(), ck.float())
    scores = scores.reshape(b, h, t, -1) / (hd ** 0.5)
    col = torch.arange(ck.shape[1], device=q.device)
    if positions.dim() == 1:
        positions = positions[None]
    visible = col[None, None, None, :] <= positions[:, None, :, None]
    scores = scores.masked_fill(~visible, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    a = torch.einsum("bkrts,bskd->btkrd",
                     probs.reshape(b, kv_heads, rep, t, -1), cv.to(q.dtype))
    return a.reshape(b, t, h * hd)
