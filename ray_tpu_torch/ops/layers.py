"""Normalization layers (port of ray_tpu/ops/layers.py).

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
