"""Attention forward (port of ray_tpu/ops/attention.py).

`flash_attention` runs the hand-written Hopper kernel (`csrc/flash_fwd.cu`)
on CUDA tensors and the plain version below on CPU tensors. Layout
[B, T, H, D]; a causal mask is aligned to the END of the kv sequence
(query i sees keys j <= i + tk - tq), as in the JAX reference. The
backward comes with the training slice; the returned LSE is what it
will read.
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward: (O [B, Tq, H, D], natural-log LSE [B*H, Tq]
    fp32). The Hopper kernel for CUDA tensors (it raises on inputs it
    does not take), the plain version for CPU tensors."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if q.is_cuda:
        return kernels.flash_fwd(q, k, v, causal, scale)
    b, tq, h, _ = q.shape
    logits = _masked_logits(q, k, causal, scale)
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, tq)
    return _attend(logits, v, q.dtype), lse
