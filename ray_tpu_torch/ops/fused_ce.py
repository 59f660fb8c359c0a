"""Fused linear + cross-entropy, forward and backward (port of
ray_tpu/ops/fused_ce.py).

`linear_cross_entropy` computes the per-row loss of logits = x @ w.T
without writing the [N, V] logits to device memory, and is
differentiable in x and w (`LinearCrossEntropy`, the port's twin of the
JAX `custom_vjp`). On CUDA tensors the forward runs the hand-written
Hopper kernel `csrc/ce_fwd.cu` and the backward the two kernels of
`csrc/ce_bwd.cu` (P W for dx, P^T xg for dW), with the one-hot terms and
the upstream scaling in PyTorch, as the JAX package leaves them to XLA.
On CPU tensors both directions run the plain versions below. Rows of w
at or past `vocab_size` are padding and masked.
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
    """Plain version of the two backward kernels: (P w [N, d], P^T xg
    [V, d]) in fp32, P = exp(x w^T - lse) over the live rows of w; rows
    of P^T xg at or past vocab_size are zero."""
    wl = w[:vocab_size].float()
    p = torch.exp(x.float() @ wl.T - lse[:, None])
    ptxg = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    ptxg[:vocab_size] = p.T @ xg.float()
    return p @ wl, ptxg


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
    """The backward on the card: `ce_dx` and `ce_dw` for the products,
    the one-hot terms and the scaling by g in PyTorch, in the order of
    `_ce_bwd_reference`."""
    gf = g.float()[:, None]
    dx = (kernels.ce_dx(x, w, lse, vocab_size) - w[targets].float()) * gf
    xg = (x.float() * gf).to(x.dtype)
    dw = kernels.ce_dw(x, w, xg, lse, vocab_size)
    dw.index_add_(0, targets, -xg.float())
    return dx.to(x.dtype), dw.to(w.dtype)


def fused_ce_supported(n: int, d: int, v: int, device: torch.device,
                       dtype: torch.dtype, backward: bool = False) -> bool:
    """True iff the fused kernels run for these shapes on this device —
    the forward, and the two backward kernels too when `backward` —
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
    tensors the backward launches `ce_dx` and `ce_dw`, with the one-hot
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
