"""Fused linear + cross-entropy forward (port of ray_tpu/ops/fused_ce.py).

`linear_cross_entropy` computes the per-row loss of logits = x @ w.T
without writing the [N, V] logits to device memory: the hand-written
Hopper kernel (`csrc/ce_fwd.cu`) for CUDA tensors, the plain version
below for CPU tensors. Rows of w at or past `vocab_size` are padding and
masked. The backward comes with the training slice; the returned LSE is
what it will read.
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


def fused_ce_supported(n: int, d: int, v: int, device: torch.device,
                       dtype: torch.dtype) -> bool:
    """True iff the fused kernel runs for these shapes on this device —
    `gpt2_loss` dispatches on it, so everything else takes the model's
    own chunked path, never the unchunked full-logit reference."""
    return (torch.device(device).type == "cuda" and n > 0 and v > 0
            and kernels.ce_fwd_supported(d, dtype, device))


def linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                         targets: torch.Tensor, vocab_size: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row CE of x @ w.T: (loss [N], lse [N]) fp32. The kernel for
    CUDA tensors (it raises on inputs it does not take), the plain
    version for CPU tensors."""
    if x.is_cuda:
        return kernels.ce_fwd(x, w, targets, vocab_size)
    return _ce_reference(x, w, targets, vocab_size)
