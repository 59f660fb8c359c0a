"""Continuous-batching generation engine (port of
ray_tpu/models/engine.py).

One fixed-shape greedy decode loop over `max_batch` slots, on a thread
of its own. Every tick runs one ragged-batch decode step (per-slot
positions and masking) over all slots. Between ticks the loop applies a
queued weight swap, frees cancelled slots and admits new requests, in
that order; finished sequences (EOS or their token budget) free their
slot as they end. Slots the engine is not using decode rows that
nothing reads.

Admission rides the paged KV prefix cache (`kvcache.PagedKVCache`, on
unless `prefix_cache=False`): it looks up the longest cached block-
aligned prefix of the prompt, gathers those blocks and prefills only the
suffix, in a full max_seq_len window, the same shapes as `generate()`'s
prefill; then it commits the prompt's new blocks and copies the prompt's
[0, prompt_len) rows into a free slot of the decode slab in place, one
copy for K and one for V. At most `max_prefills_per_tick` admissions run
between two ticks, so a burst of arrivals cannot stall every in-flight
decode for the whole drain. A weight swap (`update_params`) drops the
prefix index, so no later admission matches KV of the old weights.

Adoption (`adopt_prefill`): a prompt prefilled elsewhere, its KV rows
and first token, is spliced into a free slot between ticks by the same
copy, with no prefill here; adoptions are admitted before prefills,
under a cap of their own (`max_adoptions_per_tick`).

Speculative decoding (`speculate_k` > 0): between ticks a prompt-lookup
proposer drafts up to k tokens per slot (a scripted `draft_source`, else
the output memory of finished requests with the same prompt, the prefix
cache's token chains, and the slot's own trailing n-gram), and one
verify step feeds every slot [last token, draft...] through the same
ragged decode; the longest draft prefix that equals the greedy chain is
accepted. Each accepted token is the one the plain tick would have
produced, and a rejected draft's KV rows need no rollback: they stay
masked until a later step overwrites them.

Multi-tenant LoRA (`lora_pool`, a `serve.lora.AdapterPool`): a request's
`adapter_id` is pinned on the caller's thread; its prefill runs on
weights merged with its adapter, and the prefix cache keys its blocks
by (tenant, adapter version); the decode tick hands every slot's pool
row to the model, which adds each slot's low-rank delta.

Telemetry, as the JAX engine's: `publish_kv_telemetry` pushes
`kv_stats()` and the pool's and the speculation's timeline events to the
conductor (`util.state.kv_cache_stats()` / `speculation_stats()`, the
timeline's kvcache lane), at most every 0.5 s unless forced; it runs
after admissions, cancels, a weight swap and `stop()`, and without a
cluster only drains the event buffers. `spec_metrics()` is the
``ray_tpu_spec_*`` family on `util.metrics`, created with the first
speculating engine.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..tree import tree_device
from .convert import numpy_tensor
from .generate import _model_fns, merge_lora_params
from .kvcache import PagedKVCache, resolve_pool_config

_DONE = object()
_ENGINE_SEQ = itertools.count()
_SPEC_EVENTS_KEPT = 512
_TELEMETRY_INTERVAL_S = 0.5

# ----------------------------------------------------- prometheus (lazy)
# Created with the first speculating engine, never at import.

_spec_metrics: Optional[Dict[str, Any]] = None
_spec_metrics_lock = threading.Lock()


def spec_metrics() -> Dict[str, Any]:
    """The ``ray_tpu_spec_*`` family (JAX's names, help and tags)."""
    global _spec_metrics
    m = _spec_metrics
    if m is not None:
        return m
    with _spec_metrics_lock:
        if _spec_metrics is None:
            from ..util.metrics import Counter, Gauge

            _spec_metrics = dict(
                proposed=Counter(
                    "ray_tpu_spec_proposed_total",
                    "draft tokens proposed to the verify pass"),
                accepted=Counter(
                    "ray_tpu_spec_accepted_total",
                    "draft tokens accepted (greedy-agreeing prefix)"),
                acceptance_rate=Gauge(
                    "ray_tpu_spec_acceptance_rate",
                    "lifetime accepted/proposed draft-token ratio per "
                    "engine (counters are process-global; the gauge is "
                    "engine-tagged so co-resident engines can't "
                    "last-writer-wins each other)",
                    tag_keys=("engine",)))
    return _spec_metrics

# `_prefill_paged` calls in this process: a process that only adopts
# (serve/disagg.DecodeServer) keeps it at 0. The JAX package reads the
# size of its jitted prefill's compile cache for the same purpose.
_prefill_calls = 0
_prefill_calls_lock = threading.Lock()


def prefill_paged_calls() -> int:
    """How many prefills this process has run (`_prefill_paged`)."""
    with _prefill_calls_lock:
        return _prefill_calls


def _prefill_paged(params: Any, suffix: torch.Tensor, config: Any,
                   prefix_k: torch.Tensor, prefix_v: torch.Tensor):
    """Prefill one sequence's suffix [1, T] on top of a cached prefix
    ([L, c, H, hd]; c = 0 is the full prefill) in a fresh max_seq_len
    window, the reduction shapes of `generate()`'s prefill. Returns (the
    last position's logits [1, padded_vocab], the filled window k, v
    [L, S, H, hd])."""
    global _prefill_calls
    with _prefill_calls_lock:
        _prefill_calls += 1
    fwd = _model_fns(config)[0]
    c = prefix_k.shape[1]
    shape = (prefix_k.shape[0], config.max_seq_len) + prefix_k.shape[2:]
    ck = torch.zeros(shape, dtype=prefix_k.dtype, device=suffix.device)
    cv = torch.zeros_like(ck)
    if c:
        ck[:, :c] = prefix_k
        cv[:, :c] = prefix_v
    # per-layer views: the model's in-place cache writes land in ck, cv
    cache = [{"k": k[None], "v": v[None]} for k, v in zip(ck, cv)]
    logits, _ = fwd(params, suffix, config, cache, c)
    return logits[:, -1], ck, cv


def _prefill_paged_lora(params: Any, suffix: torch.Tensor, config: Any,
                        prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                        lora: Any):
    """`_prefill_paged` under one tenant's adapter (`AdapterPool.
    adapter_slice`): a prefill serves one request, so it runs on weights
    with the adapter merged in, made for this call and dropped after
    it."""
    return _prefill_paged(merge_lora_params(params, config, lora), suffix,
                          config, prefix_k, prefix_v)


def _prefill_with_cache(params: Any, config: Any,
                        kv_cache: Optional[PagedKVCache], prompt: np.ndarray,
                        empty_prefix: torch.Tensor,
                        event_extra: Optional[Dict[str, Any]] = None,
                        adapter: Any = None,
                        namespace: Optional[str] = None):
    """Prefill behind the prefix cache: lookup, gather, `_prefill_paged`
    on the suffix, note_prefilled, commit, the prefix_hit event, then the
    greedy first token and its logprob. `prompt` is [1, T] on the host.
    Returns (ck, cv, block table, first token, score, outcome, reused
    tokens, suffix length); the caller owns the table's pins (an empty
    table without a cache). With `adapter` (one tenant's slice) the
    prefill runs under it, and the cache is looked up and committed in
    `namespace`, so one tenant's KV never matches another's."""
    plen = prompt.shape[1]
    outcome, reused, match = "miss", 0, None
    if kv_cache is not None:
        match = kv_cache.lookup(prompt[0], max_tokens=plen - 1,
                                namespace=namespace)
        outcome, reused = match.outcome, match.tokens
        prefix_k, prefix_v = kv_cache.gather(match)
    else:
        prefix_k = prefix_v = empty_prefix
    cached = int(prefix_k.shape[1])
    suffix = torch.from_numpy(prompt[:, cached:]).to(empty_prefix.device)
    if adapter is not None:
        last_logits, ck, cv = _prefill_paged_lora(
            params, suffix, config, prefix_k, prefix_v, adapter)
    else:
        last_logits, ck, cv = _prefill_paged(params, suffix, config,
                                             prefix_k, prefix_v)
    table: List[int] = []
    if kv_cache is not None:
        kv_cache.note_prefilled(suffix.shape[1])
        table = kv_cache.commit(prompt[0], ck, cv, match,
                                namespace=namespace)
        if match.tokens:
            event = {"kind": "prefix_hit", "outcome": outcome,
                     "reused_tokens": reused, "prompt_tokens": plen}
            event.update(event_extra or {})
            kv_cache.record_event(event)
    live = last_logits[0, :config.vocab_size].float()
    first = int(live.argmax())
    score = float(live[first] - torch.logsumexp(live, dim=0))
    return (ck, cv, table, first, score, outcome, int(reused),
            int(suffix.shape[1]))


def _splice_slot(slab_k: torch.Tensor, slab_v: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, slot: int,
                 plen: int) -> None:
    """Copy a prefilled sequence's [0, plen) rows of every layer (ck, cv
    [L, >= plen, H, hd]) into batch slot `slot` of the decode slab
    [L, B, S, H, hd], in place."""
    slab_k[:, slot, :plen].copy_(ck[:, :plen])
    slab_v[:, slot, :plen].copy_(cv[:, :plen])


def _tick(params: Any, config: Any, cache: List[dict],
          tokens: torch.Tensor, pos_vec: torch.Tensor, lora: Any = None):
    """One greedy decode step over every slot: (next token, its logprob),
    [B] for tokens [B], [B, k+1] for the speculative verify form [B, k+1]
    (column 0 each slot's last token, then its draft). With `lora` (the
    JAX engine's `_tick_lora`, the argument `AdapterPool.dispatch_tick`
    builds) each slot decodes under its own adapter; a slot on the null
    adapter decodes the base model."""
    logits, _ = _model_fns(config)[2](params, tokens, config, cache,
                                      pos_vec, lora)
    live = logits[..., :config.vocab_size].float()
    nxt = live.argmax(dim=-1)
    lp = live.max(dim=-1).values - torch.logsumexp(live, dim=-1)
    return nxt, lp


class _Adoption:
    """A pending adoption: a prompt's KV rows prefilled elsewhere and the
    first token its last position gave, spliced in between ticks."""

    __slots__ = ("req", "plen", "ck", "cv", "first_token", "score")

    def __init__(self, req: "_Request", plen: int, ck: torch.Tensor,
                 cv: torch.Tensor, first_token: int, score: float):
        self.req = req
        self.plen = int(plen)
        self.ck = ck
        self.cv = cv
        self.first_token = int(first_token)
        self.score = float(score)


class _Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int,
                 eos_token: Optional[int]):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.eos_token = eos_token
        self.out: "queue.Queue" = queue.Queue()
        self.produced = 0
        # this request's speculation tally
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.slot: Optional[int] = None
        self.cache_outcome: Optional[str] = None  # hit | partial | miss
        self.reused_tokens = 0
        self.block_table: List[int] = []
        # logprob of each emitted token, in stream order
        self.scores: List[float] = []
        # the known context (prompt + emitted) the proposer drafts from;
        # empty for an adoption that came without its prompt tokens.
        # ctx_has_prompt: ctx[:plen] is the prompt, so the output memory
        # may key on it
        self.ctx: List[int] = []
        self.ctx_has_prompt = False
        # the self n-gram index over ctx: {n-gram: latest start of an
        # occurrence ending before the tail}, kept up as tokens arrive;
        # ng_indexed = the ctx positions already folded in
        self.ngram_last: Dict[tuple, int] = {}
        self.ng_indexed = 0
        # multi-tenant LoRA: the tenant and its pinned pool row (0 = base)
        self.adapter_id: Optional[str] = None
        self.lora_slot = 0
        # cancel_slot(): the slot (and its pins) is freed at the next tick
        # boundary; `finished` guards against a second release
        self.cancelled = False
        self.cancel_reason: Optional[str] = None
        self.finished = False


class TokenStream:
    """Iterator over one request's tokens, with the prefix-cache outcome
    of its admission (`cache_outcome`: hit | partial | miss, set before
    the first token arrives). Raises if the engine's decode loop failed
    while the request was live."""

    def __init__(self, req: _Request, timeout_s: float):
        self._req = req
        self._timeout_s = timeout_s

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        tok = self._req.out.get(timeout=self._timeout_s)
        if tok is _DONE:
            raise StopIteration
        if isinstance(tok, BaseException):
            raise RuntimeError("engine decode loop failed") from tok
        return int(tok)

    @property
    def cache_outcome(self) -> Optional[str]:
        return self._req.cache_outcome

    @property
    def reused_tokens(self) -> int:
        return self._req.reused_tokens

    @property
    def scores(self) -> List[float]:
        """Per-token logprobs of the tokens emitted so far."""
        return list(self._req.scores)


class ContinuousBatchingEngine:
    """Greedy continuous-batching decode over `max_batch` slots, on the
    parameters' device. The prefix cache's pool holds `kv_pool_blocks`
    blocks of `kv_block_size` tokens (0: `max_batch` windows' worth,
    doubled under `kv_int8`, which stores the pool in int8 with
    per-block-channel scales). `speculate_k` > 0 verifies up to k drafted
    tokens per slot a step (`draft_source(ctx, k) -> tokens` replaces the
    built-in proposer); `lora_pool` serves per-request adapters."""

    def __init__(self, params: Any, config: Any, *, max_batch: int = 8,
                 idle_sleep_s: float = 0.002,
                 params_version: Optional[int] = None,
                 prefix_cache: bool = True, kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, kv_int8: bool = False,
                 max_prefills_per_tick: int = 1,
                 max_adoptions_per_tick: int = 4,
                 lora_pool: Any = None, speculate_k: int = 0,
                 draft_source: Optional[Callable[[List[int], int],
                                                 List[int]]] = None):
        self.params = params
        self.config = config
        self.max_batch = max_batch
        self.idle_sleep_s = idle_sleep_s
        self.engine_id = f"cb-{os.getpid()}-{next(_ENGINE_SEQ)}"
        # a queued (params, version, events) is applied between ticks
        self.params_version = params_version
        self._pending_swap: Optional[tuple] = None
        self.swap_count = 0
        self.max_prefills_per_tick = max(1, int(max_prefills_per_tick))
        # a splice is cheap next to a prefill, hence the looser cap
        self.max_adoptions_per_tick = max(1, int(max_adoptions_per_tick))
        self.device = tree_device(params)
        # the decode slab, K and V each [L, B, S, H, hd]; the model reads
        # and writes it through per-layer views
        probe = _model_fns(config)[1](config, 1, max_len=1,
                                      device=self.device)
        kv_shape, dtype = probe[0]["k"].shape[2:], probe[0]["k"].dtype
        self._slab_k = torch.zeros(
            (len(probe), max_batch, config.max_seq_len) + kv_shape,
            dtype=dtype, device=self.device)
        self._slab_v = torch.zeros_like(self._slab_k)
        self._cache = [{"k": k, "v": v}
                       for k, v in zip(self._slab_k, self._slab_v)]
        self._empty_prefix = self._slab_k[:, 0, :0]
        self.kv_int8 = bool(kv_int8)
        block_size, pool_blocks = resolve_pool_config(
            config, kv_block_size, kv_pool_blocks, slots=max_batch,
            int8=self.kv_int8)
        self.kv_cache: Optional[PagedKVCache] = (
            PagedKVCache(config, block_size=block_size,
                         num_blocks=pool_blocks, int8=self.kv_int8,
                         device=self.device)
            if prefix_cache else None)
        # speculative decoding: k drafted tokens per slot verified in one
        # widened step; 0 is the plain loop
        self.speculate_k = max(0, int(speculate_k))
        self.draft_source = draft_source
        # greedy decode under fixed weights is a function of (adapter,
        # prompt): a finished request's chain drafts the next request
        # with the same prompt. A stale entry costs acceptance, never
        # correctness (the verify step decides); a weight swap clears it.
        # Decode loop only.
        self._output_memory: "OrderedDict[tuple, List[int]]" = OrderedDict()
        self._output_memory_cap = 128
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_verify_ticks = 0
        self.spec_emitted = 0  # tokens emitted by slots that drafted
        self._spec_events: List[Dict[str, Any]] = []
        if self.speculate_k:
            spec_metrics()  # registered before the first tick
        self._last_stats_push = 0.0
        # admission accounting (kv_stats)
        self.prefill_calls = 0
        self.prefilled_tokens = 0
        self.spliced_tokens = 0
        self.admitted = 0
        self.prefill_admitted = 0
        self.adopted = 0
        self.max_prefills_admitted_per_tick = 0
        self.max_adoptions_admitted_per_tick = 0
        self.cancelled = 0
        # the same count by the caller's reason (deadline | disconnect |
        # preempt | ... | unspecified)
        self.cancelled_by_reason: Dict[str, int] = {}
        self._tokens = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)
        self._slot_req: List[Optional[_Request]] = [None] * max_batch
        self._free = list(range(max_batch))
        # multi-tenant LoRA: each slot's adapter-pool row (0 = base)
        self.lora_pool = lora_pool
        self._slot_adapter = np.zeros(max_batch, np.int64)
        if lora_pool is not None and self.kv_cache is not None:
            # namespaces carry the adapter version, so a swapped adapter
            # never matches old KV; this only reclaims the old blocks now
            kv = self.kv_cache
            lora_pool.add_swap_listener(
                lambda tenant, old: kv.invalidate(
                    namespace=lora_pool.cache_namespace(tenant, old)))
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._pending_adopt: "queue.Queue[_Adoption]" = queue.Queue()
        self._cancels = 0  # cancelled requests not yet finished
        self._lock = threading.Lock()
        self._next_rid = 0
        self._error: Optional[BaseException] = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cb-engine")
        self._thread.start()

    # ------------------------------------------------------------- API
    def _check_tokens(self, tokens: np.ndarray, what: str) -> None:
        # an id past the embedding table would fail the gather on the loop
        # thread, and on CUDA take every live stream down with it
        if tokens.size and (tokens.min() < 0
                            or tokens.max() >= self.config.vocab_size):
            raise ValueError(f"{what} token ids must lie in [0, "
                             f"{self.config.vocab_size})")

    def _acquire_adapter(self, adapter_id: Optional[str]) -> int:
        """The pool row pinned for `adapter_id` (0 without one), on the
        caller's thread, so a cold page-in never stalls the loop."""
        if adapter_id is None:
            return 0
        if self.lora_pool is None:
            raise ValueError(f"request for adapter {adapter_id!r} but this "
                             f"engine has no lora_pool")
        return self.lora_pool.acquire(adapter_id)

    def _enqueue(self, req: _Request, fifo: "queue.Queue", item: Any) -> None:
        """Queue a request for the loop, or raise if the loop has failed
        (its adapter pin is dropped then)."""
        with self._lock:
            if self._error is None:
                fifo.put(item)
                return
        if req.adapter_id is not None:
            self.lora_pool.release(req.adapter_id)
        raise RuntimeError("engine decode loop failed") from self._error

    def _new_request(self, prompt: np.ndarray, max_new: int,
                     eos_token: Optional[int]) -> _Request:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        return _Request(rid, prompt, max_new, eos_token)

    def submit(self, prompt_tokens, max_new_tokens: int,
               eos_token: Optional[int] = None,
               adapter_id: Optional[str] = None) -> _Request:
        """Queue a request. With `adapter_id` it decodes under that
        tenant's adapter, pinned (and paged in) here, on the caller's
        thread, and released when the request ends."""
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        if prompt.shape[1] < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens "
                             ">= 1")
        if prompt.shape[1] + max_new_tokens > self.config.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        self._check_tokens(prompt, "prompt")
        req = self._new_request(prompt, max_new_tokens, eos_token)
        req.ctx = [int(t) for t in prompt[0]]
        req.ctx_has_prompt = True
        req.lora_slot = self._acquire_adapter(adapter_id)
        req.adapter_id = adapter_id
        self._enqueue(req, self._pending, req)
        return req

    def stream(self, prompt_tokens, max_new_tokens: int,
               eos_token: Optional[int] = None,
               timeout_s: float = 120.0,
               adapter_id: Optional[str] = None) -> TokenStream:
        """Submit and yield tokens as the shared loop produces them."""
        req = self.submit(prompt_tokens, max_new_tokens, eos_token,
                          adapter_id=adapter_id)
        return TokenStream(req, timeout_s)

    def generate(self, prompt_tokens, max_new_tokens: int,
                 eos_token: Optional[int] = None,
                 timeout_s: float = 120.0,
                 adapter_id: Optional[str] = None) -> List[int]:
        return list(self.stream(prompt_tokens, max_new_tokens, eos_token,
                                timeout_s, adapter_id=adapter_id))

    def adopt_prefill(self, prompt_len: int, first_token: int, ck: Any,
                      cv: Any, max_new_tokens: int,
                      eos_token: Optional[int] = None, *,
                      score: float = 0.0,
                      cache_outcome: Optional[str] = None,
                      reused_tokens: int = 0,
                      adapter_id: Optional[str] = None,
                      prompt_tokens: Optional[List[int]] = None,
                      timeout_s: float = 120.0) -> TokenStream:
        """Adopt a prompt whose prefill ran elsewhere: ck, cv [L,
        prompt_len, H, hd] (tensors or numpy arrays) are its KV rows and
        `first_token` the token its last position gave. The loop splices
        the rows into a free slot between ticks and never prefills the
        request. Layout and dtype are checked here, on the caller's
        thread, and a mismatch raises: nothing is cast. The rows move to
        the engine's device here; a tensor already there is used as it
        is, so the caller leaves it unwritten until the first token
        arrives. `prompt_tokens` gives the proposer the prompt to draft
        from. Returns the request's TokenStream, whose first token is
        `first_token`."""
        plen = int(prompt_len)
        if plen < 1 or max_new_tokens < 1:
            raise ValueError("need prompt_len >= 1 and max_new_tokens >= 1")
        # the same bound as submit(), so both admissions refuse alike
        if plen + max_new_tokens > self.config.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        self._check_tokens(np.asarray([first_token], np.int64), "first")
        if prompt_tokens is not None:
            prompt_tokens = [int(t) for t in prompt_tokens]
            if len(prompt_tokens) != plen:
                raise ValueError(f"{len(prompt_tokens)} prompt tokens for "
                                 f"prompt_len {plen}")
            self._check_tokens(np.asarray(prompt_tokens, np.int64),
                               "prompt")
        kv = [x if isinstance(x, torch.Tensor) else numpy_tensor(x)
              for x in (ck, cv)]
        ref = self._slab_k
        want = (ref.shape[0], plen) + tuple(ref.shape[3:])
        if any(tuple(x.shape) != want or x.dtype != ref.dtype for x in kv):
            raise ValueError(
                f"adopted KV layout k={tuple(kv[0].shape)}:{kv[0].dtype} "
                f"v={tuple(kv[1].shape)}:{kv[1].dtype} does not match this "
                f"engine's {want}:{ref.dtype}: the prefill and decode sides "
                f"must run the same model config")
        ck, cv = (x.to(self.device) for x in kv)
        req = self._new_request(np.zeros((1, plen), np.int64),
                                max_new_tokens, eos_token)
        if prompt_tokens is not None:
            req.ctx = prompt_tokens
            req.ctx_has_prompt = True
        req.cache_outcome = cache_outcome
        req.reused_tokens = int(reused_tokens)
        req.lora_slot = self._acquire_adapter(adapter_id)
        req.adapter_id = adapter_id
        self._enqueue(req, self._pending_adopt,
                      _Adoption(req, plen, ck, cv, first_token, score))
        return TokenStream(req, timeout_s)

    def update_params(self, params: Any,
                      version: Optional[int] = None) -> threading.Event:
        """Queue a weight swap; the decode loop applies it between ticks,
        so in-flight requests keep their KV rows and decode under the new
        weights from the next tick on. Returns an Event set once the swap
        is applied. Two swaps queued between the same two ticks coalesce:
        the newer wins, both events fire."""
        ev = threading.Event()
        with self._lock:
            prev = self._pending_swap
            self._pending_swap = (params, version,
                                  (prev[2] + [ev]) if prev else [ev])
        if self._stopped.is_set() and not self._thread.is_alive():
            # the loop has exited: apply here, so the waiter is not
            # stranded (never mid-tick: no tick runs any more)
            self._apply_pending_swap()
        return ev

    def _apply_pending_swap(self) -> None:
        """Decode loop only, between ticks (or after the loop ended)."""
        with self._lock:
            pending, self._pending_swap = self._pending_swap, None
        if pending is None:
            return
        params, version, events = pending
        self.params = params
        self.params_version = version
        self.swap_count += 1
        # every cached block, and every remembered chain, came from the
        # old weights
        self._output_memory.clear()
        if self.kv_cache is not None:
            self.kv_cache.invalidate()
            self.publish_kv_telemetry(force=True)
        for ev in events:
            ev.set()

    def cancel_slot(self, stream_or_req: Any,
                    reason: Optional[str] = None) -> bool:
        """Cancel a live or queued request (its TokenStream or the request
        itself): the loop frees its slot, its KV pins and its adapter pin
        at the next tick boundary, and its stream ends. Returns False if
        the request had already finished or been cancelled. `reason` is
        counted in `cancelled_by_reason`."""
        req = getattr(stream_or_req, "_req", stream_or_req)
        with self._lock:
            if req.finished or req.cancelled:
                return False
            req.cancelled = True
            req.cancel_reason = reason
            self._cancels += 1
        return True

    def _apply_cancels(self) -> None:
        """Decode loop only, between ticks: free cancelled active slots
        (queued cancelled requests are dropped at admission)."""
        with self._lock:
            if self._cancels == 0:
                return
        for req in list(self._slot_req):
            if req is not None and req.cancelled and not req.finished:
                self._count_cancel(req)
                self._finish(req)
        self.publish_kv_telemetry()

    def _count_cancel(self, req: _Request) -> None:
        key = req.cancel_reason or "unspecified"
        self.cancelled += 1
        self.cancelled_by_reason[key] = \
            self.cancelled_by_reason.get(key, 0) + 1

    def stop(self) -> None:
        self._stopped.set()
        self._thread.join(timeout=10.0)
        self._apply_pending_swap()  # fire waiters a stopped loop strands
        self.publish_kv_telemetry(force=True)

    @property
    def active_slots(self) -> int:
        with self._lock:
            return self.max_batch - len(self._free)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def kv_stats(self) -> Dict[str, Any]:
        """Prefix-cache, admission and speculation counters, the JAX
        engine's keys. `prefill_programs` is -1: there is no compile
        cache to count."""
        s: Dict[str, Any] = (self.kv_cache.stats() if self.kv_cache
                             else {"enabled": False})
        s.update(
            engine_id=self.engine_id,
            max_batch=self.max_batch,
            max_prefills_per_tick=self.max_prefills_per_tick,
            max_adoptions_per_tick=self.max_adoptions_per_tick,
            admitted=self.admitted,
            prefill_admitted=self.prefill_admitted,
            adopted=self.adopted,
            max_prefills_admitted_per_tick=(
                self.max_prefills_admitted_per_tick),
            max_adoptions_admitted_per_tick=(
                self.max_adoptions_admitted_per_tick),
            prefill_calls=self.prefill_calls,
            prefill_programs=-1,
            spliced_tokens=self.spliced_tokens,
            cancelled=self.cancelled,
            cancelled_by_reason=dict(self.cancelled_by_reason),
            lora=self.lora_pool is not None,
        )
        s.update(self.speculation_stats())
        if self.kv_cache is None:
            # an uncached engine still accounts its prefill work
            s.setdefault("prefilled_tokens", self.prefilled_tokens)
            s.setdefault("reused_tokens", 0)
        return s

    def speculation_stats(self) -> Dict[str, Any]:
        """Speculation counters. `tokens_per_verify` counts the tokens of
        the slots that drafted, per verify step."""
        proposed, ticks = self.spec_proposed, self.spec_verify_ticks
        return {
            "speculate_k": self.speculate_k,
            "spec_proposed": proposed,
            "spec_accepted": self.spec_accepted,
            "spec_verify_ticks": ticks,
            "spec_emitted_tokens": self.spec_emitted,
            "acceptance_rate": (self.spec_accepted / proposed
                                if proposed else 0.0),
            "tokens_per_verify": (self.spec_emitted / ticks
                                  if ticks else 0.0),
            "kv_int8": self.kv_int8,
        }

    def publish_kv_telemetry(self, force: bool = False) -> None:
        """Push `kv_stats()` and the pending kvcache / speculation events
        to the conductor (best effort; without a cluster the buffers are
        only drained). At most every 0.5 s unless `force`."""
        now = time.monotonic()
        if not force and now - self._last_stats_push < _TELEMETRY_INTERVAL_S:
            return
        self._last_stats_push = now
        from .._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is None:
            if self.kv_cache is not None:
                self.kv_cache.drain_events()  # keep the buffer bounded
            self._drain_spec_events()
            return
        try:
            w.conductor.notify("report_kvcache_stats", w.worker_id,
                               self.engine_id, self.kv_stats())
            if self.kv_cache is not None:
                for ev in self.kv_cache.drain_events():
                    ev.setdefault("engine", self.engine_id)
                    w.conductor.notify("report_kvcache_event", ev)
            # spec_accept / spec_reject ride the kvcache lane; the engine
            # buffers them itself, since a decode replica has no pool
            for ev in self._drain_spec_events():
                w.conductor.notify("report_kvcache_event", ev)
        except Exception:  # noqa: BLE001 — cluster shutting down
            pass

    # ------------------------------------------------------- admission
    def _admit(self) -> None:
        # adoptions first (a splice, no prefill), then prefills, each
        # under its own cap
        adopted = 0
        while self._free and adopted < self.max_adoptions_per_tick:
            try:
                adoption = self._pending_adopt.get_nowait()
            except queue.Empty:
                break
            if self._adopt_one(adoption):
                adopted += 1
        admitted = 0
        while self._free and admitted < self.max_prefills_per_tick:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            if self._admit_one(req):
                admitted += 1
        self.max_adoptions_admitted_per_tick = max(
            self.max_adoptions_admitted_per_tick, adopted)
        self.max_prefills_admitted_per_tick = max(
            self.max_prefills_admitted_per_tick, admitted)
        if adopted or admitted:
            self.publish_kv_telemetry()

    def _take_slot(self, req: _Request) -> Optional[int]:
        """A free slot for `req`, or None (and the request ends) when it
        was cancelled before admission."""
        if req.cancelled:
            self._count_cancel(req)
            self._finish(req)
            return None
        with self._lock:
            slot = self._free.pop()
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_adapter[slot] = req.lora_slot
        return slot

    def _adopt_one(self, adoption: _Adoption) -> bool:
        req = adoption.req
        slot = self._take_slot(req)
        if slot is None:
            return False
        _splice_slot(self._slab_k, self._slab_v, adoption.ck, adoption.cv,
                     slot, adoption.plen)
        self.spliced_tokens += adoption.plen
        self.admitted += 1
        self.adopted += 1
        self._tokens[slot] = adoption.first_token
        self._pos[slot] = adoption.plen
        self._emit(req, adoption.first_token, adoption.score)
        return True

    def _admit_one(self, req: _Request) -> bool:
        slot = self._take_slot(req)
        if slot is None:
            return False
        plen = req.prompt.shape[1]
        adapter = namespace = None
        if req.adapter_id is not None:
            # slice and version read together: the namespace names the
            # adapter this prefill computes under, even if the row is
            # swapped meanwhile
            adapter, version = self.lora_pool.adapter_slice(
                req.lora_slot, with_version=True)
            namespace = self.lora_pool.cache_namespace(req.adapter_id,
                                                       version)
        ck, cv, table, first, score, outcome, reused, suffix_len = \
            _prefill_with_cache(self.params, self.config, self.kv_cache,
                                req.prompt, self._empty_prefix,
                                event_extra={"rid": req.rid},
                                adapter=adapter, namespace=namespace)
        if self.kv_cache is not None:
            req.cache_outcome = outcome
            req.reused_tokens = reused
            req.block_table = table
        self.prefill_calls += 1
        self.prefilled_tokens += suffix_len
        _splice_slot(self._slab_k, self._slab_v, ck, cv, slot, plen)
        self.spliced_tokens += plen
        self.admitted += 1
        self.prefill_admitted += 1
        self._tokens[slot] = first
        self._pos[slot] = plen
        self._emit(req, first, score)
        return True

    def _finish(self, req: _Request) -> None:
        """Decode loop only: end a request's stream and free its slot, KV
        pins and adapter pin (completion, a cancel before admission and a
        cancel at a tick boundary all come here, so nothing is released
        twice)."""
        if self.speculate_k and not req.cancelled and req.ctx_has_prompt:
            plen = req.prompt.shape[1]
            if len(req.ctx) > plen:
                # (adapter, prompt) -> the whole greedy chain, for the
                # next request with the same prompt
                key = (req.adapter_id, tuple(req.ctx[:plen]))
                self._output_memory[key] = list(req.ctx)
                self._output_memory.move_to_end(key)
                while len(self._output_memory) > self._output_memory_cap:
                    self._output_memory.popitem(last=False)
        req.out.put(_DONE)
        slot = req.slot
        if slot is not None:
            self._slot_req[slot] = None
            self._slot_adapter[slot] = 0
        if self.kv_cache is not None and req.block_table:
            self.kv_cache.release(req.block_table)
            req.block_table = []
        if req.adapter_id is not None:
            self.lora_pool.release(req.adapter_id)
        with self._lock:
            req.finished = True
            if slot is not None:
                self._free.append(slot)
            if req.cancelled:
                self._cancels -= 1

    def _emit(self, req: _Request, tok: int, score: float) -> None:
        req.ctx.append(int(tok))
        req.scores.append(score)
        req.out.put(tok)
        req.produced += 1
        if (req.eos_token is not None and tok == req.eos_token) \
                or req.produced >= req.max_new:
            self._finish(req)

    def _fail(self, err: BaseException) -> None:
        """Decode loop only: hand the loop's exception to every live,
        queued and pending-adoption request, so no stream waits for tokens
        that never come."""
        with self._lock:
            self._error = err
        live = [r for r in self._slot_req if r is not None]
        for fifo, of_item in ((self._pending, lambda r: r),
                              (self._pending_adopt, lambda a: a.req)):
            while True:
                try:
                    live.append(of_item(fifo.get_nowait()))
                except queue.Empty:
                    break
        for req in live:
            req.out.put(err)

    # ----------------------------------------------------- speculation
    def _propose(self, req: _Request, k: int) -> List[int]:
        """Up to `k` draft tokens continuing `req.ctx`: the scripted
        `draft_source` if there is one, else the chain a finished request
        with the same (adapter, prompt) decoded, else the prefix cache's
        token chains (base requests), else the latest earlier occurrence
        of the context's trailing 3- or 2-gram. Drafts pin nothing and may
        be wrong: the verify step alone accepts."""
        if self.draft_source is not None:
            return [int(t) for t in self.draft_source(req.ctx, k)][:k]
        ctx = req.ctx
        plen = req.prompt.shape[1]
        if req.ctx_has_prompt and len(ctx) >= plen:
            mem = self._output_memory.get((req.adapter_id,
                                           tuple(ctx[:plen])))
            if mem is not None and len(mem) > len(ctx) \
                    and mem[:len(ctx)] == ctx:
                return mem[len(ctx):len(ctx) + k]
        if self.kv_cache is not None and req.adapter_id is None:
            # a tenant's chains live under its versioned namespace, which
            # the loop does not look up per step: tenants draft from their
            # own history
            draft = self.kv_cache.propose(ctx, k)
            if draft:
                return draft
        # fold in the n-grams ending before the tail, so a hit is always
        # an earlier occurrence
        ng = req.ngram_last
        ll = len(ctx)
        for end in range(req.ng_indexed, ll - 1):
            for n in (2, 3):
                if end + 1 >= n:
                    start = end + 1 - n
                    ng[tuple(ctx[start:end + 1])] = start
        req.ng_indexed = max(req.ng_indexed, ll - 1)
        for n in (3, 2):
            if ll <= n:
                continue
            start = ng.get(tuple(ctx[-n:]))
            if start is not None:
                return ctx[start + n:start + n + k]
        return []

    def _collect_drafts(self) -> Dict[int, List[int]]:
        drafts: Dict[int, List[int]] = {}
        for slot, req in enumerate(self._slot_req):
            if req is None or req.cancelled:
                continue
            # never draft past the budget: those tokens would be thrown
            # away
            budget = req.max_new - req.produced - 1
            if budget <= 0:
                continue
            d = self._propose(req, min(self.speculate_k, budget))
            if d:
                drafts[slot] = d
        return drafts

    def _spec_event(self, ev: Dict[str, Any]) -> None:
        ev.setdefault("ts", time.time())
        ev.setdefault("engine", self.engine_id)
        with self._lock:
            self._spec_events.append(ev)
            if len(self._spec_events) > _SPEC_EVENTS_KEPT:
                del self._spec_events[:len(self._spec_events)
                                      - _SPEC_EVENTS_KEPT]

    def _drain_spec_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._spec_events = self._spec_events, []
        return out

    def _decode(self, tokens: np.ndarray, lora_live: bool):
        """One decode step of the slab on host tokens [B] or [B, k+1] at
        the slots' positions: (next tokens, logprobs) on the host."""
        tok = torch.from_numpy(tokens).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        if lora_live:
            nxt, lp = self.lora_pool.dispatch_tick(
                lambda la: _tick(self.params, self.config, self._cache,
                                 tok, pos, la), self._slot_adapter)
        else:
            nxt, lp = _tick(self.params, self.config, self._cache, tok, pos)
        return nxt.cpu().numpy(), lp.cpu().numpy()

    def _spec_tick(self, drafts: Dict[int, List[int]],
                   lora_live: bool) -> None:
        """One verify step: feed [last token, draft...] per slot and emit
        the longest prefix of the greedy chain the draft agrees with. A
        slot without a draft repeats its last token; its column 0 is the
        plain tick's token."""
        k = self.speculate_k
        toks = np.repeat(self._tokens[:, None], k + 1, axis=1)
        for slot, d in drafts.items():
            toks[slot, 1:1 + len(d)] = d
        nxt, lp = self._decode(toks, lora_live)
        self.spec_verify_ticks += 1
        m = spec_metrics()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            proposal = drafts.get(slot, ())
            tok = int(nxt[slot, 0])
            self._pos[slot] += 1
            self._tokens[slot] = tok
            self._emit(req, tok, float(lp[slot, 0]))
            accepted = 0
            for i, d in enumerate(proposal):
                # accept d_i while it is the greedy chain's last token and
                # the request is live (an EOS or budget finish stops the
                # stream where the plain loop would)
                if req.finished or int(d) != tok:
                    break
                tok = int(nxt[slot, i + 1])
                self._pos[slot] += 1
                self._tokens[slot] = tok
                self._emit(req, tok, float(lp[slot, i + 1]))
                accepted += 1
            if proposal:
                self.spec_emitted += 1 + accepted
                self.spec_proposed += len(proposal)
                self.spec_accepted += accepted
                req.spec_proposed += len(proposal)
                req.spec_accepted += accepted
                m["proposed"].inc(len(proposal))
                if accepted:
                    m["accepted"].inc(accepted)
                self._spec_event({
                    "kind": "spec_accept" if accepted else "spec_reject",
                    "rid": req.rid, "slot": slot,
                    "proposed": len(proposal), "accepted": accepted})
        if self.spec_proposed:
            m["acceptance_rate"].set(
                self.spec_accepted / self.spec_proposed,
                tags={"engine": self.engine_id})

    # ------------------------------------------------------------ loop
    def _loop(self) -> None:
        # inference mode is thread-local: the loop thread enters it itself
        with torch.inference_mode():
            try:
                while not self._stopped.is_set():
                    self._step()
            except Exception as err:  # noqa: BLE001 — reported to callers
                self._fail(err)
                raise

    def _step(self) -> None:
        self._apply_pending_swap()
        self._apply_cancels()
        self._admit()
        if all(r is None for r in self._slot_req):
            self._stopped.wait(self.idle_sleep_s)
            return
        lora_live = bool(self._slot_adapter.any())
        drafts = self._collect_drafts() if self.speculate_k else {}
        if drafts:
            self._spec_tick(drafts, lora_live)
            return
        nxt, lp = self._decode(self._tokens, lora_live)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._pos[slot] += 1
            tok = int(nxt[slot])
            self._tokens[slot] = tok
            self._emit(req, tok, float(lp[slot]))
