"""Rotary position embeddings, split-half (GPT-NeoX) convention (port of
ray_tpu/ops/rope.py).

fp32 cos/sin tables, the rotation computed in fp32 and cast back. Plain
PyTorch: elementwise work beside the q/k projections, which the JAX
package leaves to XLA and the port to PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def rope_table(head_dim: int, max_seq_len: int, theta: float = 10000.0,
               device: Union[str, torch.device, None] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [max_seq_len, head_dim // 2] fp32."""
    if head_dim % 2:
        raise ValueError("RoPE needs an even head_dim")
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [T, hd/2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate q or k. x [B, T, H, hd]; cos/sin [>= T, hd/2]; positions
    [B, T] ints (arange when None; decode-time offsets otherwise)."""
    t = x.shape[1]
    if positions is None:
        c = cos[:t][None, :, None, :]  # [1, T, 1, hd/2]
        s = sin[:t][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]  # [B, T, 1, hd/2]
        s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
