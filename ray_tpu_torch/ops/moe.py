"""Mixture-of-experts feed-forward with expert parallelism over the `ep`
mesh axis (port of ray_tpu/ops/moe.py).

The GShard / Switch recipe as the JAX package writes it: top-k routing
with a static capacity per expert, dispatch and combine as dense one-hot
products (`[T, E, C]`), the dispatch product in fp32 and the expert
products in x's dtype, and under `shard_map` an untiled `all_to_all` over
the `ep` axis that hands each rank every rank's capacity slots of its
local experts. Tokens past an expert's capacity are dropped (their
combine weight is 0). The JAX package has no kernel here, and neither
does the port: plain PyTorch on the card too.

Top-k order: `jax.lax.top_k` puts the lower expert index first among
equal probabilities, and router logits in bf16 tie on real inputs;
`torch.topk` promises no order on ties, so the top k come from a stable
descending sort. No gradient flows through the indices: the gate gets its
gradient from the chosen probabilities (and the balancing loss).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import RowSplit, all_to_all, axis_size


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def top_k_stable(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last dim, the
    lower index first among equal values (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_routing(logits: torch.Tensor, top_k: int, num_experts: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch [T, E, C] 0/1, combine [T, E, C] routing weights), fp32."""
    t = logits.shape[0]
    probs = torch.softmax(logits.float(), dim=-1)                # [T, E]
    topv, topi = top_k_stable(probs, top_k)                      # [T, k]
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(topi.T, num_experts).float()              # [k, T, E]
    # each (choice, token)'s place in its expert's queue: a count over
    # choices-major, token-minor order (GShard's)
    flat = onehot.reshape(top_k * t, num_experts)
    pos = (flat.cumsum(0) - flat).reshape(top_k, t, num_experts)
    in_cap = (pos < capacity).float() * onehot
    pos_idx = (pos * onehot).sum(-1).to(torch.int64)             # [k, T]
    cap_onehot = F.one_hot(pos_idx.clamp(0, capacity - 1),
                           capacity).float()                     # [k, T, C]
    disp_k = torch.einsum("kte,ktc->ktec", in_cap, cap_onehot)
    dispatch = disp_k.sum(0)                                     # [T, E, C]
    combine = torch.einsum("ktec,kt->tec", disp_k, topv.T)
    return dispatch, combine


def capacity_of(tokens: int, top_k: int, capacity_factor: float,
                num_experts: int) -> int:
    """Slots per expert: max(1, ceil(k T cf / E)) in Python floats."""
    return max(1, math.ceil(top_k * tokens * capacity_factor
                            / num_experts))


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25,
            axis_name: Optional[str] = None,
            activation: Callable[[torch.Tensor], torch.Tensor] = gelu_tanh,
            return_router_logits: bool = False,
            rows: Optional[RowSplit] = None):
    """MoE feed-forward. x: [T, D] (or [B, S, D], flattened inside).

    gate_w [D, E]. With axis_name=None: w_in [E, D, F], w_out [E, F, D].
    Inside `shard_map` over `axis_name`: w_in [E/ep, D, F] and w_out
    [E/ep, F, D], this rank's experts, with tokens exchanged by
    `all_to_all`. return_router_logits=True returns (y, logits [T, E])
    for `load_balancing_loss`.

    rows: x is this rank's block of a batch split on its rows (a mesh
    TrainStep's `parallel.mesh.row_split()`, axis_name None). The
    routing then takes the whole batch, as JAX's GSPMD step computes it:
    every rank gathers the rows, routes and runs them, and returns its
    own rows of y, with the whole batch's router logits."""
    orig_shape = x.shape
    if x.dim() == 3:
        x = x.reshape(-1, x.shape[-1])
    split = rows is not None and rows.blocks > 1
    if split:
        if axis_name is not None:
            raise ValueError("moe_ffn takes rows= only without axis_name")
        x = rows.gather(x)
    t, d = x.shape

    ep = 1 if axis_name is None else axis_size(axis_name)
    e_local = w_in.shape[0]
    e = e_local * ep
    capacity = capacity_of(t, top_k, capacity_factor, e)

    logits = x @ gate_w.to(x.dtype)                              # [T, E]
    dispatch, combine = _top_k_routing(logits, top_k, e, capacity)

    xin = torch.einsum("tec,td->ecd", dispatch, x.float())
    if axis_name is not None:
        # [E, C, D] -> [ep, E_l, C, D]: block j to rank j, which then
        # holds every rank's slots of its own experts
        xin = xin.reshape(ep, e_local, capacity, d)
        xin = all_to_all(xin, axis_name, split_axis=0, concat_axis=0)
        xin = xin.transpose(0, 1).reshape(e_local, ep * capacity, d)

    xin = xin.to(x.dtype)
    h = activation(torch.einsum("ecd,edf->ecf", xin, w_in))
    out = torch.einsum("ecf,efd->ecd", h, w_out)                 # [E_l, ., D]

    if axis_name is not None:
        out = out.reshape(e_local, ep, capacity, d).transpose(0, 1)
        out = all_to_all(out, axis_name, split_axis=0, concat_axis=0)
        out = out.reshape(e, capacity, d)

    y = torch.einsum("tec,ecd->td", combine, out.float()).to(x.dtype)
    if split:
        y = rows.own(y)
    y = y.reshape(orig_shape)
    if return_router_logits:
        return y, logits
    return y


def load_balancing_loss(logits: torch.Tensor, top_k: int = 2
                        ) -> torch.Tensor:
    """Switch's auxiliary loss, E * sum_e(frac_tokens_e * mean_prob_e), of
    router logits [..., T, E]."""
    probs = torch.softmax(logits.float(), dim=-1)
    e = probs.shape[-1]
    _, topi = top_k_stable(probs, top_k)
    counts = F.one_hot(topi, e).float().sum(-2)                  # [..., E]
    frac = counts.reshape(-1, e).mean(0) / top_k
    mean_prob = probs.reshape(-1, e).mean(0)
    return e * (frac * mean_prob).sum()


__all__ = ["capacity_of", "gelu_tanh", "load_balancing_loss", "moe_ffn",
           "top_k_stable"]
