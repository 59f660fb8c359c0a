"""Autoregressive generation over the KV cache (port of
ray_tpu/models/generate.py: the GPT-2 and Llama families).

Prefill is one forward over the prompt into a fresh max_seq_len cache;
decoding is a Python loop of one-token forwards (JAX's `lax.scan`), the
cache updated in place where JAX donates it.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

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
