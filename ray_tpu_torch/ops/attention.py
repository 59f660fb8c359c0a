"""Flash attention, forward and backward (port of ray_tpu/ops/attention.py).

`flash_attention` is differentiable (`FlashAttention`, the port's twin of
the JAX `custom_vjp`). On CUDA tensors the forward runs the hand-written
Hopper kernel `csrc/flash_fwd.cu`, and the backward the two kernels of
`csrc/flash_bwd.cu` (dQ, then dK/dV, as the JAX package's default
two-pass backward), which recompute P from the saved LSE. On CPU tensors
both directions run the plain versions below. Layout [B, T, H, D]; a
causal mask is aligned to the END of the kv sequence (query i sees keys
j <= i + tk - tq), as in the JAX reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

_NEG_INF = -1e30


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


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, sm_scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, natural-log LSE [B*H, Tq] fp32): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.is_cuda:
        return kernels.flash_fwd(q, k, v, causal, sm_scale)
    b, tq, h, _ = q.shape
    logits = _masked_logits(q, k, causal, sm_scale)
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, tq)
    return _attend(logits, v, q.dtype), lse


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
    """Plain version of the two backward kernels: (dQ, dK, dV) in the
    input dtypes, from the forward's O and natural-log LSE [B*H, Tq].
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
    PyTorch and launches `flash_bwd_dq` and `flash_bwd_dkv`; on CPU
    tensors it runs `_flash_bwd_reference`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = _flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
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
            return dq, dk, dv, None, None
        dcor = softmax_correction(o, do)
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, dcor, causal, scale)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, dcor, causal, scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention: (O [B, Tq, H, D], natural-log LSE [B*H, Tq] fp32),
    differentiable in q, k and v. The Hopper kernels for CUDA tensors
    (they raise on inputs they do not take), the plain versions for CPU
    tensors."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    return FlashAttention.apply(q, k, v, causal, scale)
