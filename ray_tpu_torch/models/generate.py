"""Autoregressive generation over the KV cache (port of
ray_tpu/models/generate.py: the GPT-2 and Llama families).

Prefill is one forward over the prompt into a fresh max_seq_len cache;
decoding is a Python loop of one-token forwards (JAX's `lax.scan`), the
cache updated in place where JAX donates it. `stream_generate` yields
each step's tokens as they land, for a caller that streams them.
`lora_targets` and `merge_lora_params` are the LoRA helpers the serving
engine and `serve.lora` share.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from ..tree import tree_device
from .gpt2 import (GPT2Config, gpt2_decode, gpt2_forward_cached,
                   gpt2_init_kv_cache)
from .llama import (LlamaConfig, init_kv_cache, llama_decode,
                    llama_forward_cached)


def _model_fns(config) -> Tuple[Callable, Callable, Callable]:
    """(forward_cached, init_cache, ragged_decode) for the config's model
    family — generation and the continuous-batching engine are
    model-agnostic over this cache protocol."""
    if isinstance(config, LlamaConfig):
        return llama_forward_cached, init_kv_cache, llama_decode
    if isinstance(config, GPT2Config):
        return gpt2_forward_cached, gpt2_init_kv_cache, gpt2_decode
    raise TypeError(f"no generation support for {type(config).__name__}")


def lora_targets(config) -> Tuple[Tuple[str, int, int], ...]:
    """The LoRA-target leaves of a model family, ``((leaf name, in_dim,
    out_dim), ...)``, each an entry of every block's ``["attn"]``: the
    one table the adapter pool's layout, the decode gather and the
    prefill merge all read."""
    if isinstance(config, LlamaConfig):
        kv_dim = config.num_kv_heads * config.head_dim
        return (("wq", config.d_model, config.d_model),
                ("wv", config.d_model, kv_dim))
    if isinstance(config, GPT2Config):
        return (("qkv", config.d_model, 3 * config.d_model),)
    raise TypeError(f"no LoRA support for {type(config).__name__}")


def merge_lora_params(params: Any, config: Any, lora: Any) -> Any:
    """The base parameters with one adapter folded into the target leaves,
    ``W + scale * (A_l @ B_l)`` per block, the product summed in fp32 and
    rounded once to W's dtype. `lora` is one adapter's slice
    ``{"scale": scalar, "targets": {name: {"a": [L, in, r], "b": [L, r,
    out]}}}`` (`serve.lora.AdapterPool.adapter_slice`). The prefill of a
    single-tenant request runs on it; the base tree is not changed."""
    lora_targets(config)  # validates the family
    blocks = []
    for li, p in enumerate(params["blocks"]):
        attn = dict(p["attn"])
        for name, ab in lora["targets"].items():
            w = attn[name]
            delta = ab["a"][li].float() @ ab["b"][li].float()
            attn[name] = w + (delta * lora["scale"]).to(w.dtype)
        blocks.append({**p, "attn": attn})
    return {**params, "blocks": blocks}


def _sample(logits: torch.Tensor, vocab_size: int, temperature: float,
            top_k: int, generator: Optional[torch.Generator]
            ) -> torch.Tensor:
    logits = logits[..., :vocab_size]  # padded vocab is never sampled
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if 0 < top_k < vocab_size:
        kth = logits.sort(dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


@torch.inference_mode()
def generate(params: Any, config: Any, prompt: Any, *,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, generator: Optional[torch.Generator] = None,
             eos_token: Optional[int] = None) -> torch.Tensor:
    """Batched generation: prompt [B, T0] ints -> [B, max_new_tokens]
    int64 on the parameters' device. Greedy at temperature 0, else
    top-k / temperature sampling from `generator` (which must live on
    that device). With eos_token, tokens after a sequence's first EOS
    are replaced by EOS."""
    device = tree_device(params)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, t0 = prompt.shape
    if t0 + max_new_tokens > config.max_seq_len:
        raise ValueError(
            f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({config.max_seq_len})")
    fwd, init_cache, _ = _model_fns(config)
    cache = init_cache(config, b, device=device)
    logits, cache = fwd(params, prompt, config, cache, 0)
    tok = _sample(logits[:, -1], config.vocab_size, temperature, top_k,
                  generator)
    toks = [tok]
    for pos in range(t0, t0 + max_new_tokens - 1):
        logits, cache = fwd(params, tok[:, None], config, cache, pos)
        tok = _sample(logits[:, -1], config.vocab_size, temperature, top_k,
                      generator)
        toks.append(tok)
    out = torch.stack(toks, dim=1)
    if eos_token is not None:
        hit = (out == eos_token).long().cumsum(dim=1) > 0
        done_before = torch.zeros_like(hit)
        done_before[:, 1:] = hit[:, :-1]
        out = out.masked_fill(done_before, eos_token)
    return out


@torch.inference_mode()
def stream_generate(params: Any, config: Any, prompt: Any, *,
                    max_new_tokens: int, temperature: float = 0.0,
                    top_k: int = 0,
                    generator: Optional[torch.Generator] = None,
                    eos_token: Optional[int] = None
                    ) -> Iterator[torch.Tensor]:
    """Yield one [B] int64 token batch per decode step, on the parameters'
    device: the tokens `generate()` returns, column by column, from the
    same `generator`. With eos_token, a sequence that has emitted EOS
    yields EOS from then on, and the stream ends once every sequence
    has."""
    device = tree_device(params)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, t0 = prompt.shape
    if t0 + max_new_tokens > config.max_seq_len:
        raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
    fwd, init_cache, _ = _model_fns(config)
    cache = init_cache(config, b, device=device)
    logits, cache = fwd(params, prompt, config, cache, 0)
    tok = _sample(logits[:, -1], config.vocab_size, temperature, top_k,
                  generator)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    for pos in range(t0, t0 + max_new_tokens):
        out = tok
        if eos_token is not None:
            out = tok.masked_fill(done, eos_token)
            done = done | (tok == eos_token)
        yield out
        if pos + 1 == t0 + max_new_tokens or (
                eos_token is not None and bool(done.all())):
            return
        logits, cache = fwd(params, tok[:, None], config, cache, pos)
        tok = _sample(logits[:, -1], config.vocab_size, temperature, top_k,
                      generator)
