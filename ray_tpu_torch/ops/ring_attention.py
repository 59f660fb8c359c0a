"""Ring attention: exact attention over a sequence sharded on the `sp`
mesh axis, K/V blocks rotating by `ppermute` (port of
ray_tpu/ops/ring_attention.py).

Each sp rank holds a [B, T/sp, H, D] block of q, k and v. For sp steps
every rank attends its queries to the K/V block it holds, folding the
partial results into an online (flash-style) softmax in fp32, then
passes the block to the next rank. At step s a rank holds the block of
rank (rank - s) mod sp. Under a causal mask a block wholly in the
future gives every score -1e30 (not -inf, which would make a NaN), and
its weight exp(m_block - m_new) is then 0. A Python loop replaces JAX's
`lax.scan`; autograd runs through the port's differentiable `ppermute`.
Plain PyTorch: the JAX package has no kernel here.

Inside `shard_map` with q, k, v split on the sequence axis:
    out = ring_attention(q, k, v, axis_name="sp", causal=True)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.mesh import axis_index, axis_size, ppermute

_NEG_INF = -1e30


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's flash partials (m, l, acc) in fp32. q [B, Tq, H, D],
    k and v [B, Tk, H, D], mask [Tq, Tk] bool or None; m and l
    [B, H, Tq, 1], acc [B, H, Tq, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)  # a wholly masked block is zeroed by its weight
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over an sp-sharded sequence. Per-rank shapes: q,
    k, v [B, T_blk, H, D]; returns [B, T_blk, H, D] in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    sp = axis_size(axis_name)
    rank = axis_index(axis_name)
    b, t_blk, h, d = q.shape
    dev = q.device
    floor = torch.tensor(_NEG_INF, device=dev)
    m = torch.full((b, h, t_blk, 1), _NEG_INF, device=dev)
    l = torch.zeros(b, h, t_blk, 1, device=dev)
    acc = torch.zeros(b, h, t_blk, d, device=dev)
    idx = torch.arange(t_blk, device=dev)
    ring = [(i, (i + 1) % sp) for i in range(sp)]
    k_cur, v_cur = k, v
    for step in range(sp):
        src = (rank - step) % sp  # the rank whose kv block is held now
        mask = None
        if causal:
            mask = (rank * t_blk + idx[:, None]) >= (src * t_blk + idx)
        m_cur, l_cur, acc_cur = _block_attend(q, k_cur, v_cur, mask,
                                              sm_scale)
        m_new = torch.maximum(m, m_cur)
        alpha_prev = torch.exp(torch.maximum(m, floor) - m_new)
        alpha_cur = torch.exp(torch.maximum(m_cur, floor) - m_new)
        l = alpha_prev * l + alpha_cur * l_cur
        acc = alpha_prev * acc + alpha_cur * acc_cur
        m = m_new
        if step + 1 < sp:  # the block after the last step is never read
            k_cur = ppermute(k_cur, axis_name, ring)
            v_cur = ppermute(v_cur, axis_name, ring)
    out = acc / l.clamp(min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # [B, T_blk, H, D]


__all__ = ["ring_attention"]
