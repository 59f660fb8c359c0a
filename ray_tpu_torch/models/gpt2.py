"""GPT-2 as plain functions on tensors (port of ray_tpu/models/gpt2.py).

Same parameter layout as the JAX package — a dict with the keys `wte`,
`wpe`, `ln_f`, `blocks[i].{ln_1, attn, ln_2, mlp}`, weights [in, out]
used as `x @ W`, `wte` [padded_vocab, d] tied as the LM head — so
`convert.from_jax_params` carries a JAX pytree over with nothing but a
copy. bf16 parameters and activations by default, fp32 layer-norm
statistics, fp32 logits.

On CUDA tensors the full forward reaches the two Hopper kernels:
attention in `_block` (`ops.attention.flash_attention`) and the LM-head
loss in `gpt2_loss` (`ops.fused_ce.linear_cross_entropy`); both are
differentiable, their backward the four backward kernels, so
`gpt2_loss` is the training loss (`train.step.TrainStep`). The cached
prefill/decode path computes attention in plain PyTorch, as the JAX
package does with einsums. Matrix products of the working dtype go to
`torch.matmul`, which accumulates bf16 in fp32 on the card, as XLA does
for the JAX package.

`remat=True` checkpoints each block (`torch.utils.checkpoint`, as
`jax.checkpoint` in the JAX package): the backward recomputes one block
at a time. Differences from the JAX package: the KV cache is updated in
place (where JAX returns a new buffer and donates the old one), and
there is no sharding constraint or LoRA here yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import cached_attention, flash_attention
from ..ops.fused_ce import fused_ce_supported, linear_cross_entropy
from ..ops.layers import fp32_logits, layer_norm

Params = Dict[str, Any]
Device = Union[str, torch.device, None]


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    dtype: torch.dtype = torch.bfloat16
    # vocab padded up so the LM head tiles evenly
    vocab_pad_multiple: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @staticmethod
    def small() -> "GPT2Config":  # 124M
        return GPT2Config()

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config(num_layers=24, num_heads=16, d_model=1024)

    @staticmethod
    def tiny() -> "GPT2Config":  # test size
        return GPT2Config(vocab_size=512, max_seq_len=128, num_layers=2,
                          num_heads=4, d_model=128)


def gpt2_init(config: GPT2Config,
              generator: Optional[torch.Generator] = None,
              device: Device = "cuda") -> Params:
    """Random parameters (GPT-2 scheme: N(0, 0.02), residual projections
    scaled by 1/sqrt(2*n_layers)), drawn on the CPU from `generator`
    (seed 0 when None) and moved to `device`."""
    c = config
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)

    def norm(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen) * scale).to(dev, c.dtype)

    def ones(n):
        return torch.ones(n, dtype=c.dtype, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=c.dtype, device=dev)

    resid_scale = 0.02 / np.sqrt(2 * c.num_layers)
    params: Params = {
        "wte": norm(c.padded_vocab, c.d_model),
        "wpe": norm(c.max_seq_len, c.d_model, scale=0.01),
        "ln_f": {"scale": ones(c.d_model), "bias": zeros(c.d_model)},
        "blocks": [],
    }
    for _ in range(c.num_layers):
        params["blocks"].append({
            "ln_1": {"scale": ones(c.d_model), "bias": zeros(c.d_model)},
            "attn": {
                "qkv": norm(c.d_model, 3 * c.d_model),
                "qkv_b": zeros(3 * c.d_model),
                "proj": norm(c.d_model, c.d_model, scale=resid_scale),
                "proj_b": zeros(c.d_model),
            },
            "ln_2": {"scale": ones(c.d_model), "bias": zeros(c.d_model)},
            "mlp": {
                "fc": norm(c.d_model, 4 * c.d_model),
                "fc_b": zeros(4 * c.d_model),
                "proj": norm(4 * c.d_model, c.d_model, scale=resid_scale),
                "proj_b": zeros(c.d_model),
            },
        })
    return params


def _attn_proj_res(x: torch.Tensor, a: torch.Tensor, p: Params
                   ) -> torch.Tensor:
    """Attention output projection + residual (shared by the full,
    prefill and per-slot decode blocks)."""
    return x + a @ p["attn"]["proj"] + p["attn"]["proj_b"]


def _mlp_res(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = layer_norm(x, p["ln_2"]["scale"], p["ln_2"]["bias"])
    # tanh-approximate gelu: GPT-2's historical activation
    h = F.gelu(h @ p["mlp"]["fc"] + p["mlp"]["fc_b"], approximate="tanh")
    return x + h @ p["mlp"]["proj"] + p["mlp"]["proj_b"]


def _qkv(x: torch.Tensor, p: Params, config: GPT2Config
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-head q, k, v [B, t, H, hd] — views into one fused product."""
    c = config
    b, t, _ = x.shape
    h = layer_norm(x, p["ln_1"]["scale"], p["ln_1"]["bias"])
    qkv = h @ p["attn"]["qkv"] + p["attn"]["qkv_b"]
    q, k, v = qkv.split(c.d_model, dim=-1)
    shape = (b, t, c.num_heads, c.head_dim)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _block(x: torch.Tensor, p: Params, config: GPT2Config) -> torch.Tensor:
    b, t, _ = x.shape
    q, k, v = _qkv(x, p, config)
    a = flash_attention(q, k, v, True)[0].reshape(b, t, config.d_model)
    return _mlp_res(_attn_proj_res(x, a, p), p)


def gpt2_hidden(params: Params, tokens: torch.Tensor,
                config: GPT2Config, remat: bool = False) -> torch.Tensor:
    """tokens [B, T] int -> final hidden states [B, T, d_model].
    remat=True checkpoints each block: its activations are recomputed in
    the backward, so peak activation memory is one block's worth."""
    t = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:t]
    for p in params["blocks"]:
        if remat:
            x = checkpoint(_block, x, p, config, use_reentrant=False)
        else:
            x = _block(x, p, config)
    return layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])


def gpt2_forward(params: Params, tokens: torch.Tensor,
                 config: GPT2Config) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, padded_vocab] (fp32)."""
    return fp32_logits(gpt2_hidden(params, tokens, config), params["wte"].T)


# ------------------------------------------------------- KV-cache decode


def gpt2_init_kv_cache(config: GPT2Config, batch_size: int,
                       max_len: int = 0, dtype: Optional[torch.dtype] = None,
                       device: Device = "cuda") -> List[Params]:
    """Per-layer K/V buffers [B, S, heads, head_dim], zero-filled."""
    c = config
    dev = resolve_device(device)
    shape = (batch_size, max_len or c.max_seq_len, c.num_heads, c.head_dim)
    dt = dtype or c.dtype
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(c.num_layers)]


def _block_cached(x: torch.Tensor, p: Params, config: GPT2Config,
                  cache: Params, pos: int) -> Tuple[torch.Tensor, Params]:
    """Cache-path block: tokens at [pos, pos+t) are written into the
    cache (in place) and attend the whole written prefix."""
    t = x.shape[1]
    q, k, v = _qkv(x, p, config)
    cache["k"][:, pos:pos + t] = k
    cache["v"][:, pos:pos + t] = v
    positions = pos + torch.arange(t, device=x.device)
    a = cached_attention(q, cache["k"], cache["v"], positions)
    return _mlp_res(_attn_proj_res(x, a, p), p), cache


def _block_decode(x: torch.Tensor, p: Params, config: GPT2Config,
                  cache: Params, pos_vec: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    """Ragged-batch decode with per-slot base positions pos_vec [B]
    (continuous batching); x [B, t, D]. The cache is written in place."""
    b, t = x.shape[0], x.shape[1]
    q, k, v = _qkv(x, p, config)
    rows = torch.arange(b, device=x.device)[:, None]
    positions = pos_vec[:, None] + torch.arange(t, device=x.device)[None]
    cache["k"][rows, positions] = k
    cache["v"][rows, positions] = v
    a = cached_attention(q, cache["k"], cache["v"], positions)
    return _mlp_res(_attn_proj_res(x, a, p), p), cache


def gpt2_decode(params: Params, tokens: torch.Tensor, config: GPT2Config,
                cache: List[Params], pos_vec: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step for a ragged batch: tokens [B] at per-slot
    positions pos_vec [B] -> logits [B, padded_vocab] fp32 ([B, q]
    tokens give [B, q, padded_vocab]). The cache is updated in place and
    returned."""
    ragged = tokens.dim() == 1
    if ragged:
        x = params["wte"][tokens[:, None]] + params["wpe"][pos_vec][:, None]
    else:
        positions = pos_vec[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device)[None]
        x = params["wte"][tokens] + params["wpe"][positions]
    for p, blk in zip(params["blocks"], cache):
        x, _ = _block_decode(x, p, config, blk, pos_vec)
    x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    if ragged:
        x = x[:, 0]
    return fp32_logits(x, params["wte"].T), cache


def gpt2_forward_cached(params: Params, tokens: torch.Tensor,
                        config: GPT2Config, cache: List[Params], pos: int
                        ) -> Tuple[torch.Tensor, List[Params]]:
    """Append tokens [B, T] at position `pos`: (logits [B, T,
    padded_vocab] fp32, cache updated in place). pos=0 with the whole
    prompt is prefill; T=1 afterwards is decode."""
    t = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][pos:pos + t]
    for p, blk in zip(params["blocks"], cache):
        x, _ = _block_cached(x, p, config, blk, pos)
    x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return fp32_logits(x, params["wte"].T), cache


def _ce_sum(x: torch.Tensor, targets: torch.Tensor, wte: torch.Tensor,
            vocab_size: int) -> torch.Tensor:
    """Sum of next-token cross-entropy. x [..., d], targets [...]."""
    logits = fp32_logits(x, wte.T)
    if wte.shape[0] != vocab_size:  # mask the vocab padding
        logits[..., vocab_size:] = -1e30
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).sum()


def gpt2_loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
              config: GPT2Config, remat: bool = False,
              loss_chunk_rows: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy, differentiable in the parameters.
    Through the fused kernels where `fused_ce_supported` says they run
    (the logits never reach device memory, in either direction);
    elsewhere in sequence chunks, each checkpointed, so the
    [B, T, padded_vocab] fp32 logits never materialise whole and the
    backward recomputes one chunk's logits at a time."""
    c = config
    x = gpt2_hidden(params, tokens, config, remat=remat)
    b, t = targets.shape
    wte = params["wte"]
    backward = torch.is_grad_enabled() and (x.requires_grad
                                            or wte.requires_grad)
    if fused_ce_supported(b * t, c.d_model, c.padded_vocab, x.device,
                          x.dtype, backward=backward):
        losses, _ = linear_cross_entropy(
            x.reshape(b * t, c.d_model), wte,
            targets.reshape(b * t).long(), c.vocab_size)
        return losses.sum() / (b * t)

    n_chunks = min(t, max(1, (b * t) // loss_chunk_rows))
    while t % n_chunks != 0:
        n_chunks -= 1
    tc = t // n_chunks
    if n_chunks == 1:
        return _ce_sum(x, targets, wte, c.vocab_size) / (b * t)
    total = sum(checkpoint(_ce_sum, x[:, i * tc:(i + 1) * tc],
                           targets[:, i * tc:(i + 1) * tc], wte,
                           c.vocab_size, use_reentrant=False)
                for i in range(n_chunks))
    return total / (b * t)
