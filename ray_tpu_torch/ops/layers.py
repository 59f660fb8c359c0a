"""Normalization layers and the per-slot LoRA delta (port of
ray_tpu/ops/layers.py), and the fp32 LM-head product both model families
share.

fp32 statistics whatever the input dtype, output cast back. Plain
PyTorch: the JAX side has no kernel here on purpose, and neither does
the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    # one fused PyTorch op on the fp32 values instead of the JAX
    # package's written-out mean/var: the same math in fewer launches
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def fp32_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """LM head x @ w (w [d, V]) as fp32 logits from products summed in
    fp32: the JAX package's `preferred_element_type=f32` product. On the
    card a bf16 product writes fp32 directly (`out_dtype`, tensor cores);
    elsewhere, and wherever a gradient is needed (that product has no
    derivative in PyTorch), the operands are widened first. bf16 products
    are exact in fp32, so both are the same math."""
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and x.dtype == torch.bfloat16 and not grad:
        flat = torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32)
        return flat.reshape(*x.shape[:-1], w.shape[1])
    return x.float() @ w.float()


def lora_delta(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """Per-slot LoRA contribution for a ragged decode batch, `scale *
    (h @ A) @ B` with a different adapter per batch row. h [B, t, d],
    a [B, d, r], b [B, r, o], scale [B] -> [B, t, o] in h's dtype. Both
    products are summed in fp32 and z = h @ A stays fp32 into the second,
    as JAX's `preferred_element_type=f32` einsums do (a product of bf16
    values is exact in fp32, so widening first is the same math). A row
    on the null adapter (A = B = 0, scale 0) adds an exact zero."""
    z = torch.bmm(h.float(), a.float())
    d = torch.bmm(z, b.float())
    return (d * scale.float()[:, None, None]).to(h.dtype)
