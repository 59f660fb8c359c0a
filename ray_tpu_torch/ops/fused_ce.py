"""Fused linear + cross-entropy, forward and backward (port of
ray_tpu/ops/fused_ce.py).

`linear_cross_entropy` computes the per-row loss of logits = x @ w.T
without writing the [N, V] logits to device memory, and is
differentiable in x and w (`LinearCrossEntropy`, the port's twin of the
JAX `custom_vjp`). On CUDA tensors the forward runs the hand-written
Hopper kernel `csrc/ce_fwd.cu` and the backward `kernels.ce_bwd`: the
vocabulary in chunks of `kernels.ce_chunk_width(N, V)` columns (the bf16
P of a chunk in at most 128 MiB of scratch), per chunk `ce_probs` (P),
`ce_dx` (dx += P W) and `ce_dw` (the chunk's rows of P^T xg) from
`csrc/ce_bwd.cu`, with the one-hot terms and the upstream scaling in
PyTorch, as the JAX package leaves them to XLA. On CPU tensors both
directions run the plain versions below. Rows of w at or past
`vocab_size` are padding and masked.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

_NEG_INF = -1e30


def _ce_reference(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain per-row loss and logsumexp, fp32. x [N, d], w [V, d]."""
    logits = x.float() @ w.float().T
    if w.shape[0] != vocab_size:
        logits[:, vocab_size:] = _NEG_INF
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, targets.long()[:, None])[:, 0]
    return lse - tgt, lse


def _ce_bwd_products(x: torch.Tensor, w: torch.Tensor, xg: torch.Tensor,
                     lse: torch.Tensor, vocab_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward's products (`kernels.ce_bwd`): (P w
    [N, d], P^T xg [V, d]) in fp32, P = exp(x w^T - lse) over the live
    rows of w; rows of P^T xg at or past vocab_size are zero."""
    wl = w[:vocab_size].float()
    p = torch.exp(x.float() @ wl.T - lse[:, None])
    ptxg = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    ptxg[:vocab_size] = p.T @ xg.float()
    return p @ wl, ptxg


def _ce_probs_reference(x: torch.Tensor, w: torch.Tensor,
                        lse: torch.Tensor, vocab_size: int, c0: int,
                        vc: int) -> torch.Tensor:
    """Plain version of `ce_probs`: P = exp(x w^T - lse) for the vocab
    columns [c0, c0 + vc), zero at columns at or past vocab_size (those
    rows of w are not read), rounded to x.dtype as the JAX kernels round P
    before their products ([N, vc], bf16 for bf16 x)."""
    live = max(0, min(vc, vocab_size - c0))
    p = torch.zeros((x.shape[0], vc), dtype=torch.float32, device=x.device)
    p[:, :live] = torch.exp(x.float() @ w[c0:c0 + live].float().T
                            - lse[:, None])
    return p.to(x.dtype)


def _ce_bwd_chunked(x: torch.Tensor, w: torch.Tensor, xg: torch.Tensor,
                    lse: torch.Tensor, vocab_size: int, vc: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What `kernels.ce_bwd` composes, in plain PyTorch: for each chunk of
    vc vocab columns, P_c from `_ce_probs_reference`, then dx += P_c w_c
    and the chunk's rows of dW = P_c^T xg as fp32 products (the plain
    forms of `ce_dx` and `ce_dw`). The same function as
    `_ce_bwd_products`; the CPU tests hold the two together to show that
    chunking changes nothing."""
    n, d = x.shape
    v = w.shape[0]
    dx = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((v, d), dtype=torch.float32, device=x.device)
    for c0 in range(0, v, vc):
        width = min(vc, v - c0)
        live = max(0, min(width, vocab_size - c0))
        p = _ce_probs_reference(x, w, lse, vocab_size, c0, width).float()
        dx += p[:, :live] @ w[c0:c0 + live].float()
        dw[c0:c0 + width] = p.T @ xg.float()
    return dx, dw


def _ce_bwd_reference(x: torch.Tensor, w: torch.Tensor,
                      targets: torch.Tensor, lse: torch.Tensor,
                      g: torch.Tensor, vocab_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward, step for step as the JAX
    `_ce_bwd_pallas`: with P = exp(x w^T - lse) over the live rows of w,
    dx = (P w - w[targets]) g summed in fp32, cast to x.dtype at the end;
    xg = (x g in fp32) cast to x.dtype before the dW product; dW = P^T xg
    in fp32, then -xg added at the target rows on the fp32 buffer, cast
    to w.dtype. Rows of w at or past vocab_size are never read and get a
    zero gradient."""
    gf = g.float()[:, None]
    xg = (x.float() * gf).to(x.dtype)
    pw, dw = _ce_bwd_products(x, w, xg, lse, vocab_size)
    dx = (pw - w[targets].float()) * gf
    dw.index_add_(0, targets, -xg.float())
    return dx.to(x.dtype), dw.to(w.dtype)


def _ce_bwd_kernels(x: torch.Tensor, w: torch.Tensor,
                    targets: torch.Tensor, lse: torch.Tensor,
                    g: torch.Tensor, vocab_size: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward on the card: `kernels.ce_bwd` for the two products,
    the one-hot terms and the scaling by g in PyTorch, in the order of
    `_ce_bwd_reference`."""
    gf = g.float()[:, None]
    xg = (x.float() * gf).to(x.dtype)
    pw, dw = kernels.ce_bwd(x, w, xg, lse, vocab_size)
    dx = (pw - w[targets].float()) * gf
    dw.index_add_(0, targets, -xg.float())
    return dx.to(x.dtype), dw.to(w.dtype)


def fused_ce_supported(n: int, d: int, v: int, device: torch.device,
                       dtype: torch.dtype, backward: bool = False) -> bool:
    """True iff the fused kernels run for these shapes on this device —
    the forward, and the backward kernels too when `backward` —
    `gpt2_loss` dispatches on it, so everything else takes the model's
    own chunked path, never the unchunked full-logit reference."""
    return (torch.device(device).type == "cuda" and n > 0 and v > 0
            and kernels.ce_fwd_supported(d, dtype, device)
            and (not backward or kernels.ce_bwd_supported(d, dtype, device)))


def _ce_fwd(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
            vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.is_cuda:
        return kernels.ce_fwd(x, w, targets, vocab_size)
    return _ce_reference(x, w, targets, vocab_size)


class LinearCrossEntropy(torch.autograd.Function):
    """Per-row CE of x @ w.T with the fused backward: saves x, w, the
    targets and the row LSE (returned too, non-differentiable). On CUDA
    tensors the backward runs `kernels.ce_bwd`, with the one-hot
    terms and the scaling by g in PyTorch (`index_add_` for the scatter);
    on CPU tensors it runs `_ce_bwd_reference`."""

    @staticmethod
    def forward(ctx, x, w, targets, vocab_size: int):
        loss, lse = _ce_fwd(x, w, targets, vocab_size)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.vocab_size = vocab_size
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _dlse):
        x, w, targets, lse = ctx.saved_tensors
        bwd = _ce_bwd_kernels if x.is_cuda else _ce_bwd_reference
        dx, dw = bwd(x, w, targets, lse, g, ctx.vocab_size)
        return dx, dw, None, None


def linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                         targets: torch.Tensor, vocab_size: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row CE of x @ w.T: (loss [N], lse [N]) fp32, differentiable in
    x and w. The kernels for CUDA tensors (they raise on inputs they do
    not take), the plain versions for CPU tensors."""
    return LinearCrossEntropy.apply(x, w, targets, vocab_size)
