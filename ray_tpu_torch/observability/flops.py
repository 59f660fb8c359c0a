"""FLOPs accounting for MFU: analytic training FLOPs per token of the
port's models (the numerator) and the card's dense bf16 peak (the
denominator). Port of ray_tpu/observability/flops.py's analytic part,
with a peak table for CUDA devices instead of TPU generations."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

# dense bf16 tensor-core peak FLOP/s by CUDA device name (NVIDIA data
# sheets, SXM parts, no sparsity); the longest matching prefix wins
PEAK_FLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H200": 989e12,
}


def device_peak_flops(device: Union[str, torch.device, int, None] = None
                      ) -> Optional[float]:
    """bf16 peak FLOP/s of one CUDA device (the current one for None), or
    None for a device the table does not know."""
    name = torch.cuda.get_device_name(device)
    for prefix, peak in sorted(PEAK_FLOPS_BF16.items(),
                               key=lambda kv: -len(kv[0])):
        if name.startswith(prefix):
            return peak
    return None


def param_count(cfg: Any) -> int:
    """Analytic parameter count of a GPT2Config: tied wte, wpe and 12 d^2
    per layer (qkv 3, proj 1, mlp 8), as the JAX package counts it."""
    if type(cfg).__name__ != "GPT2Config":
        raise TypeError(f"no analytic parameter count for "
                        f"{type(cfg).__name__}")
    return (cfg.padded_vocab * cfg.d_model
            + cfg.max_seq_len * cfg.d_model
            + cfg.num_layers * 12 * cfg.d_model * cfg.d_model)


def attn_flops_per_token(cfg: Any, seq: Optional[int] = None,
                         causal: bool = True) -> float:
    """Attention score/value FLOPs per token the 6N rule misses:
    2 products (QK^T, PV) x 2 d T each, forward + backward = 3x, halved
    when causal."""
    seq = seq or cfg.max_seq_len
    per = 12.0 * cfg.num_layers * cfg.d_model * seq
    return per / 2 if causal else per


def train_flops_per_token(cfg: Any, seq: Optional[int] = None,
                          causal: bool = True) -> float:
    """Training (forward + backward) FLOPs per token: 6 N plus the
    attention term."""
    return 6.0 * param_count(cfg) + attn_flops_per_token(cfg, seq, causal)


def mfu(flops_per_step: Optional[float], step_seconds: float,
        peak_flops_total: Optional[float]) -> Optional[float]:
    """Achieved / peak model FLOP/s, or None when either side is unknown."""
    if not flops_per_step or not peak_flops_total or step_seconds <= 0:
        return None
    return flops_per_step / step_seconds / peak_flops_total
