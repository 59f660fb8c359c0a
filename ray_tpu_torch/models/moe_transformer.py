"""The Mixtral-style mixture-of-experts decoder as plain functions on
tensors (port of ray_tpu/models/moe_transformer.py): Llama blocks whose
dense SwiGLU MLP is replaced by top-k routed experts (`ops.moe.moe_ffn`,
SiLU experts of two matrices) and the Switch load-balancing loss.

The JAX parameter layout: the Llama keys with `blocks[i].moe.{gate_w
[D, E], w_in [E, D, F], w_out [E, F, D]}` in place of `mlp`, so
`convert.from_jax_params` carries a JAX tree over with nothing but a
copy. Attention is the Llama port's (`_qkv`, `_rope`, `_repeat_kv`)
through `flash_attention` with its default two-pass backward, as the JAX
model calls it: on CUDA bf16 tensors the `flash_fwd`, `flash_bwd_dq` and
`flash_bwd_dkv` kernels. The experts, routing and balancing loss are
plain PyTorch, as in JAX. Experts shard on the `ep` mesh axis in
`moe_partition_specs`; the model itself calls `moe_ffn` without an axis,
as JAX's does. Under a mesh TrainStep that splits the batch rows
(`parallel.mesh.row_split()`), each layer routes the whole batch, as
JAX's GSPMD step does, and the balancing loss takes every row.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import fp32_logits, rms_norm
from ..ops.moe import load_balancing_loss, moe_ffn
from ..ops.rope import apply_rope
from ..parallel.mesh import P, RowSplit, row_split
from .llama import LlamaConfig, _mm, _qkv, _repeat_kv, _rope

Params = Dict[str, Any]
Device = Union[str, torch.device, None]


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 4
    d_model: int = 768
    d_ff: int = 2048
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    def as_llama(self) -> LlamaConfig:
        """The attention side of this config as a LlamaConfig."""
        keep = {f.name for f in dataclasses.fields(LlamaConfig)}
        return LlamaConfig(**{k: v for k, v in dataclasses.asdict(
            self).items() if k in keep})

    @staticmethod
    def tiny() -> "MoEConfig":  # test size
        return MoEConfig(vocab_size=512, max_seq_len=128, num_layers=2,
                         num_heads=4, num_kv_heads=2, d_model=128,
                         d_ff=256, num_experts=4, top_k=2)

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        return MoEConfig(vocab_size=32000, max_seq_len=4096, num_layers=32,
                         num_heads=32, num_kv_heads=8, d_model=4096,
                         d_ff=14336, num_experts=8, top_k=2,
                         rope_theta=1e6)


def moe_init(config: MoEConfig,
             generator: Optional[torch.Generator] = None,
             device: Device = "cuda") -> Params:
    """Random parameters (N(0, 0.02) weights, unit norm scales), drawn
    from `generator` (a CPU one seeded 0 when None) on its own device
    and moved to `device`; the JAX package's keys and layouts. A CUDA
    generator draws on the card: at Mixtral's widths the CPU's normals
    take ~20 s."""
    c = config
    if c.num_heads % c.num_kv_heads:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)

    def norm(*shape):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * 0.02).to(dev, c.dtype)

    def ones():
        return {"scale": torch.ones(c.d_model, dtype=c.dtype, device=dev)}

    kv_dim = c.num_kv_heads * c.head_dim
    params: Params = {
        "tok_emb": norm(c.padded_vocab, c.d_model),
        "norm_f": ones(),
        "lm_head": norm(c.d_model, c.padded_vocab),
        "blocks": [],
    }
    for _ in range(c.num_layers):
        params["blocks"].append({
            "attn_norm": ones(),
            "attn": {
                "wq": norm(c.d_model, c.d_model),
                "wk": norm(c.d_model, kv_dim),
                "wv": norm(c.d_model, kv_dim),
                "wo": norm(c.d_model, c.d_model),
            },
            "ffn_norm": ones(),
            "moe": {
                "gate_w": norm(c.d_model, c.num_experts),
                "w_in": norm(c.num_experts, c.d_model, c.d_ff),
                "w_out": norm(c.num_experts, c.d_ff, c.d_model),
            },
        })
    return params


def _moe_block(x: torch.Tensor, p: Params, cos: torch.Tensor,
               sin: torch.Tensor, config: MoEConfig,
               rows: Optional[RowSplit] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, router logits [B*T, E]) of one block."""
    c = config
    b, t, _ = x.shape
    h = rms_norm(x, p["attn_norm"]["scale"])
    q, k, v = _qkv(h, p, c)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v = _repeat_kv(k, v, c)
    a = flash_attention(q, k, v, True)[0].reshape(b, t, c.d_model)
    x = x + _mm(a, p["attn"]["wo"])

    h = rms_norm(x, p["ffn_norm"]["scale"])
    y, logits = moe_ffn(
        h, p["moe"]["gate_w"], p["moe"]["w_in"], p["moe"]["w_out"],
        top_k=c.top_k, capacity_factor=c.capacity_factor,
        activation=F.silu, return_router_logits=True, rows=rows)
    return x + y, logits


def moe_forward(params: Params, tokens: torch.Tensor, config: MoEConfig,
                return_router_logits: bool = False,
                rows: Optional[RowSplit] = None):
    """tokens [B, T] int -> logits [B, T, padded_vocab] fp32, and with
    return_router_logits=True also each layer's router logits. `rows`
    (default: `row_split()`) says how the batch is split on its rows:
    the routing takes the whole batch, and the router logits are the
    whole batch's."""
    rows = rows if rows is not None else row_split()
    cos, sin = _rope(config, tokens.device)
    x = params["tok_emb"][tokens]
    all_logits: List[torch.Tensor] = []
    for p in params["blocks"]:
        x, logits = _moe_block(x, p, cos, sin, config, rows)
        all_logits.append(logits)
    x = rms_norm(x, params["norm_f"]["scale"])
    out = fp32_logits(x, params["lm_head"])
    if return_router_logits:
        return out, all_logits
    return out


def moe_loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
             config: MoEConfig, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy (log-softmax over the fp32 logits,
    the vocab padding at -1e30) plus `aux_loss_coeff` times the mean of
    the layers' load-balancing losses. remat=True checkpoints the whole
    forward: the backward runs it again. Under a row split
    (`row_split()`) the cross-entropy is this rank's rows' mean and the
    balancing loss the whole batch's, so the mesh TrainStep's mean over
    the blocks is JAX's loss."""
    # the split goes in as an argument: the recomputed forward runs in
    # the backward, outside the step's split_rows
    rows = row_split()
    if remat:
        logits, router_logits = checkpoint(
            moe_forward, params, tokens, config, True, rows,
            use_reentrant=False)
    else:
        logits, router_logits = moe_forward(params, tokens, config, True,
                                            rows)
    if config.padded_vocab != config.vocab_size:
        logits[..., config.vocab_size:] = -1e30
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, targets.long()[..., None]).mean()
    aux = sum(load_balancing_loss(lg, config.top_k)
              for lg in router_logits) / len(router_logits)
    return ce + config.aux_loss_coeff * aux


def moe_partition_specs(config: MoEConfig) -> Params:
    """Partition-spec tree for the params (the JAX package's): experts on
    `ep`, Megatron tp / fsdp inside each expert and in attention."""
    block = {
        "attn_norm": {"scale": P()},
        "attn": {"wq": P("fsdp", "tp"), "wk": P("fsdp", "tp"),
                 "wv": P("fsdp", "tp"), "wo": P("tp", "fsdp")},
        "ffn_norm": {"scale": P()},
        "moe": {"gate_w": P(),
                "w_in": P("ep", "fsdp", "tp"),
                "w_out": P("ep", "tp", "fsdp")},
    }
    return {
        "tok_emb": P("tp", "fsdp"),
        "norm_f": {"scale": P()},
        "lm_head": P("fsdp", "tp"),
        "blocks": [block for _ in range(config.num_layers)],
    }


__all__ = ["MoEConfig", "moe_forward", "moe_init", "moe_loss",
           "moe_partition_specs"]
