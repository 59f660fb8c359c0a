"""The Llama family as plain functions on tensors (port of
ray_tpu/models/llama.py): RMSNorm, RoPE, SwiGLU, grouped-query
attention.

Same parameter layout as the JAX package — a dict with the keys
`tok_emb`, `norm_f`, `lm_head` and `blocks[i].{attn_norm, attn, ffn_norm,
mlp}`, weights [in, out] used as `x @ W`, an untied LM head
`lm_head` [d_model, padded_vocab] — so `convert.from_jax_params` carries a
JAX pytree over with nothing but a copy. bf16 parameters and activations
by default, fp32 norm statistics, RoPE and SwiGLU product, fp32 logits.

Grouped-query attention repeats each kv head `num_heads // num_kv_heads`
times in a row (`jnp.repeat` on the head axis, `repeat_interleave` here)
right before `ops.attention.flash_attention`, whose kernels take q and
k with one head count; autograd sums dK and dV back over the repeats. On
CUDA tensors every block's attention runs the `flash_fwd` kernel, and
its backward always the single-pass `flash_bwd_fused` kernel
(`fused_bwd=True`; GPT-2 keeps the two-pass pair). The loss is
log-softmax over the full fp32 logits, as the JAX `llama_loss` computes
it (no fused CE kernel on this path). The cached prefill/decode path
computes attention in plain PyTorch with fp32 scores, as the JAX package
does with einsums.

`remat=True` checkpoints the whole forward (`jax.checkpoint` of
`llama_forward` in the JAX package). Differences from the JAX package:
the KV cache is updated in place (where JAX returns a new buffer), and
there is no partition-spec tree here yet. The ragged decode takes the
mixed-tenant LoRA adapters of the serving engine (`lora=`, the layout of
`serve.lora.AdapterPool`), as the JAX package's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import (DecodeRows, cached_attention, decode_rows,
                             flash_attention, write_rows)
from ..ops.layers import fp32_logits, lora_delta, rms_norm
from ..ops.rope import apply_rope, rope_table, rotate
from ..parallel.mesh import P

Params = Dict[str, Any]
Device = Union[str, torch.device, None]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 4
    d_model: int = 768
    d_ff: int = 2048
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

    @staticmethod
    def tiny() -> "LlamaConfig":  # test size
        return LlamaConfig(vocab_size=512, max_seq_len=128, num_layers=2,
                           num_heads=4, num_kv_heads=2, d_model=128,
                           d_ff=256)

    @staticmethod
    def small() -> "LlamaConfig":  # ~125M-class
        return LlamaConfig()

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=32000, max_seq_len=4096,
                           num_layers=32, num_heads=32, num_kv_heads=32,
                           d_model=4096, d_ff=11008)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, max_seq_len=8192,
                           num_layers=32, num_heads=32, num_kv_heads=8,
                           d_model=4096, d_ff=14336, rope_theta=500000.0)


def llama_init(config: LlamaConfig,
               generator: Optional[torch.Generator] = None,
               device: Device = "cuda") -> Params:
    """Random parameters (N(0, 0.02) weights, unit norm scales), drawn on
    the CPU from `generator` (seed 0 when None) and moved to `device`."""
    c = config
    if c.num_heads % c.num_kv_heads:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)

    def norm(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(dev, c.dtype)

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
            "mlp": {
                "w_gate": norm(c.d_model, c.d_ff),
                "w_up": norm(c.d_model, c.d_ff),
                "w_down": norm(c.d_ff, c.d_model),
            },
        })
    return params


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # a product of the working dtype, summed in fp32 and rounded once (the
    # JAX `preferred_element_type=f32` + cast): what torch.matmul does
    return x @ w


def _qkv(h: torch.Tensor, p: Params, c: LlamaConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, t, _ = h.shape
    q = _mm(h, p["attn"]["wq"]).reshape(b, t, c.num_heads, c.head_dim)
    k = _mm(h, p["attn"]["wk"]).reshape(b, t, c.num_kv_heads, c.head_dim)
    v = _mm(h, p["attn"]["wv"]).reshape(b, t, c.num_kv_heads, c.head_dim)
    return q, k, v


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, c: LlamaConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA: each kv head repeated num_heads // num_kv_heads times in a row
    on the head axis (query head i reads kv head i // rep)."""
    if c.num_kv_heads != c.num_heads:
        rep = c.num_heads // c.num_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _mlp_res(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = rms_norm(x, p["ffn_norm"]["scale"])
    gate = F.silu(_mm(h, p["mlp"]["w_gate"]).float())
    up = _mm(h, p["mlp"]["w_up"]).float()
    return x + _mm((gate * up).to(x.dtype), p["mlp"]["w_down"])


def llama_block(x: torch.Tensor, p: Params, cos: torch.Tensor,
                sin: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    c = config
    b, t, _ = x.shape
    h = rms_norm(x, p["attn_norm"]["scale"])
    q, k, v = _qkv(h, p, c)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v = _repeat_kv(k, v, c)
    a = flash_attention(q, k, v, True, fused_bwd=True)[0].reshape(
        b, t, c.d_model)
    x = x + _mm(a, p["attn"]["wo"])
    return _mlp_res(x, p)


def _rope(config: LlamaConfig, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    c = config
    return rope_table(c.head_dim, c.max_seq_len, c.rope_theta, device)


def llama_forward(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, padded_vocab] fp32."""
    cos, sin = _rope(config, tokens.device)
    x = params["tok_emb"][tokens]
    for p in params["blocks"]:
        x = llama_block(x, p, cos, sin, config)
    x = rms_norm(x, params["norm_f"]["scale"])
    return fp32_logits(x, params["lm_head"])


def llama_loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
               config: LlamaConfig, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy: log-softmax over the full fp32
    logits, the vocab padding at -1e30, differentiable in the parameters.
    remat=True checkpoints the whole forward: the backward runs it again."""
    if remat:
        logits = checkpoint(llama_forward, params, tokens, config,
                            use_reentrant=False)
    else:
        logits = llama_forward(params, tokens, config)
    if config.padded_vocab != config.vocab_size:
        logits[..., config.vocab_size:] = -1e30
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


# ------------------------------------------------------- KV-cache decode


def init_kv_cache(config: LlamaConfig, batch_size: int, max_len: int = 0,
                  dtype: Optional[torch.dtype] = None,
                  device: Device = "cuda") -> List[Params]:
    """Per-layer K/V buffers [B, S, n_kv_heads, head_dim], zero-filled."""
    c = config
    dev = resolve_device(device)
    shape = (batch_size, max_len or c.max_seq_len, c.num_kv_heads,
             c.head_dim)
    dt = dtype or c.dtype
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(c.num_layers)]


def llama_block_cached(x: torch.Tensor, p: Params, cos: torch.Tensor,
                       sin: torch.Tensor, config: LlamaConfig,
                       cache: Params, pos: int
                       ) -> Tuple[torch.Tensor, Params]:
    """Cache-path block (prefill and decode): tokens land at [pos, pos+t)
    of the cache, in place, and attend everything written so far. cos and
    sin are the RoPE rows of those positions ([1, t, 1, hd/2])."""
    c = config
    b, t, _ = x.shape
    h = rms_norm(x, p["attn_norm"]["scale"])
    q, k, v = _qkv(h, p, c)
    positions = (pos + torch.arange(t, device=x.device))[None].expand(b, t)
    q = rotate(q, cos, sin)
    k = rotate(k, cos, sin)
    cache["k"][:, pos:pos + t] = k
    cache["v"][:, pos:pos + t] = v
    a = cached_attention(q, cache["k"], cache["v"], positions)
    x = x + _mm(a, p["attn"]["wo"])
    return _mlp_res(x, p), cache


def llama_forward_cached(params: Params, tokens: torch.Tensor,
                         config: LlamaConfig, cache: List[Params], pos: int
                         ) -> Tuple[torch.Tensor, List[Params]]:
    """Append tokens [B, T] at position `pos`: (logits [B, T,
    padded_vocab] fp32, cache updated in place). pos=0 with the whole
    prompt is prefill; T=1 afterwards is decode."""
    cos, sin = _rope(config, tokens.device)
    rows = slice(pos, pos + tokens.shape[1])
    cos, sin = cos[rows][None, :, None], sin[rows][None, :, None]
    x = params["tok_emb"][tokens]
    for p, blk in zip(params["blocks"], cache):
        x, _ = llama_block_cached(x, p, cos, sin, config, blk, pos)
    x = rms_norm(x, params["norm_f"]["scale"])
    return fp32_logits(x, params["lm_head"]), cache


def llama_block_decode(x: torch.Tensor, p: Params, cos: torch.Tensor,
                       sin: torch.Tensor, config: LlamaConfig,
                       cache: Params, rows: DecodeRows,
                       lora: Optional[Dict[str, Any]] = None
                       ) -> Tuple[torch.Tensor, Params]:
    """Ragged-batch decode (continuous batching): slot b's token j sits
    where `rows` says (base position pos_vec[b] + j) and attends the rows
    at or before it. x [B, t, D]; t == 1 is one tick, t == k + 1 the
    speculative verify form. cos and sin are the RoPE rows of the step's
    positions ([B, t, 1, hd/2]). The cache is written in place; a write
    past the window is dropped and a position past it reads the last
    table row, as in JAX.

    `lora` (the mixed-tenant decode): this layer's per-slot adapters,
    ``{"wq": (a [B, D, r], b [B, r, D]), "wv": (a, b), "scale": [B]}``,
    added to the wq and wv projections; a slot on the null adapter adds
    an exact zero."""
    c = config
    b, t = x.shape[0], x.shape[1]
    h = rms_norm(x, p["attn_norm"]["scale"])
    if lora is None:
        q, k, v = _qkv(h, p, c)
    else:
        q = _mm(h, p["attn"]["wq"]) + lora_delta(h, *lora["wq"],
                                                 lora["scale"])
        k = _mm(h, p["attn"]["wk"])
        v = _mm(h, p["attn"]["wv"]) + lora_delta(h, *lora["wv"],
                                                 lora["scale"])
        q = q.reshape(b, t, c.num_heads, c.head_dim)
        k = k.reshape(b, t, c.num_kv_heads, c.head_dim)
        v = v.reshape(b, t, c.num_kv_heads, c.head_dim)
    q = rotate(q, cos, sin)
    k = rotate(k, cos, sin)
    write_rows(cache["k"], rows, k)
    write_rows(cache["v"], rows, v)
    a = cached_attention(q, cache["k"], cache["v"], rows.positions)
    x = x + _mm(a, p["attn"]["wo"])
    return _mlp_res(x, p), cache


def llama_decode(params: Params, tokens: torch.Tensor, config: LlamaConfig,
                 cache: List[Params], pos_vec: torch.Tensor,
                 lora: Optional[Dict[str, Any]] = None
                 ) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step for a ragged batch: tokens [B] at per-slot
    positions pos_vec [B] -> logits [B, padded_vocab] fp32; tokens [B, q]
    (the verify form) give [B, q, padded_vocab], row j what a sequential
    decode would give after tokens[:, :j+1]. The cache is updated in
    place and returned.

    `lora`: the adapter-pool stacks and per-slot rows, ``{"idx": [B],
    "scale": [P], "wq": (a [P, L, D, r], b [P, L, r, D]), "wv": (...)}``
    (`serve.lora.AdapterPool.dispatch_tick`); each slot's adapter is
    gathered once, then every layer adds its low-rank delta."""
    cos, sin = _rope(config, tokens.device)
    ragged = tokens.dim() == 1
    if ragged:
        tokens = tokens[:, None]
    rows = decode_rows(pos_vec, tokens.shape[1], cache[0]["k"].shape[1])
    # a position past the table reads its last row (JAX's clamped gather)
    read = rows.positions.clamp(max=cos.shape[0] - 1)
    cos, sin = cos[read][:, :, None, :], sin[read][:, :, None, :]
    x = params["tok_emb"][tokens]
    sel = None
    if lora is not None:
        idx = lora["idx"]
        sel = {n: (lora[n][0][idx], lora[n][1][idx]) for n in ("wq", "wv")}
        scale = lora["scale"][idx]
    for li, (p, blk) in enumerate(zip(params["blocks"], cache)):
        lora_l = None if sel is None else {
            n: (a[:, li], b[:, li]) for n, (a, b) in sel.items()}
        if lora_l is not None:
            lora_l["scale"] = scale
        x, _ = llama_block_decode(x, p, cos, sin, config, blk, rows, lora_l)
    x = rms_norm(x, params["norm_f"]["scale"])
    if ragged:
        x = x[:, 0]
    return fp32_logits(x, params["lm_head"]), cache


def llama_partition_specs(config: LlamaConfig) -> Params:
    """Partition-spec tree for the params (the JAX package's): Megatron
    layout, q/k/v and gate/up column-parallel on tp, wo/down
    row-parallel, embeddings 2D-sharded. Collapses to replicated when the
    mesh has tp=fsdp=1."""
    block = {
        "attn_norm": {"scale": P()},
        "attn": {"wq": P("fsdp", "tp"), "wk": P("fsdp", "tp"),
                 "wv": P("fsdp", "tp"), "wo": P("tp", "fsdp")},
        "ffn_norm": {"scale": P()},
        "mlp": {"w_gate": P("fsdp", "tp"), "w_up": P("fsdp", "tp"),
                "w_down": P("tp", "fsdp")},
    }
    return {
        "tok_emb": P("tp", "fsdp"),
        "norm_f": {"scale": P()},
        "lm_head": P("fsdp", "tp"),
        "blocks": [block for _ in range(config.num_layers)],
    }
