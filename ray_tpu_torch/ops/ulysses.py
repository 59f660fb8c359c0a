"""Ulysses sequence parallelism: two `all_to_all`s over the `sp` mesh
axis trade sequence sharding for head sharding around a local attention
(port of ray_tpu/ops/ulysses.py).

Each sp rank holds [B, T/sp, H, D]; the first exchange gives it the
whole sequence for H/sp heads, any attention runs on that, and the
second exchange gives the sequence blocks back. Plain PyTorch exchanges:
the JAX package has no kernel here. The attention itself may be the
port's `flash_attention`, whose Hopper kernels then run on the card.

Inside `shard_map` with q, k, v split on the sequence axis:
    out = ulysses_attention(q, k, v, axis_name="sp")   # [B, T/sp, H, D]
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import all_to_all, axis_size
from .attention import mha_reference


def _seq_to_heads(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[B, T/sp, H, D] -> [B, T, H/sp, D]: scatter heads, gather seq."""
    return all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)


def _heads_to_seq(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[B, T, H/sp, D] -> [B, T/sp, H, D]: the inverse exchange."""
    return all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp", causal: bool = True,
                      sm_scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Exact attention over an sp-sharded sequence by head scattering.

    Per-rank shapes q, k, v: [B, T/sp, H, D], H divisible by the size of
    `axis_name`. attn_fn(q, k, v, causal, sm_scale) defaults to
    `mha_reference`; `ops.attention.flash_attention` may be passed (of
    its (O, LSE) only O is kept)."""
    sp = axis_size(axis_name)
    h = q.shape[2]
    if h % sp != 0:
        raise ValueError(f"heads {h} not divisible by sp axis size {sp}")
    fn = attn_fn or mha_reference
    qg, kg, vg = (_seq_to_heads(t, axis_name) for t in (q, k, v))
    out = fn(qg, kg, vg, causal, sm_scale)      # [B, T, H/sp, D]
    if isinstance(out, tuple):
        out = out[0]
    return _heads_to_seq(out, axis_name)        # [B, T/sp, H, D]


__all__ = ["ulysses_attention"]
