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

Not ported yet (the JAX engine has them): speculative decoding, LoRA,
adoption of remotely prefilled KV (`adopt_prefill`) and the telemetry
pushed to a cluster (`publish_kv_telemetry`).
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..tree import tree_device
from .generate import _model_fns
from .kvcache import PagedKVCache, resolve_pool_config

_DONE = object()
_ENGINE_SEQ = itertools.count()


def _prefill_paged(params: Any, suffix: torch.Tensor, config: Any,
                   prefix_k: torch.Tensor, prefix_v: torch.Tensor):
    """Prefill one sequence's suffix [1, T] on top of a cached prefix
    ([L, c, H, hd]; c = 0 is the full prefill) in a fresh max_seq_len
    window, the reduction shapes of `generate()`'s prefill. Returns (the
    last position's logits [1, padded_vocab], the filled window k, v
    [L, S, H, hd])."""
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


def _prefill_with_cache(params: Any, config: Any,
                        kv_cache: Optional[PagedKVCache], prompt: np.ndarray,
                        empty_prefix: torch.Tensor,
                        event_extra: Optional[Dict[str, Any]] = None):
    """Prefill behind the prefix cache: lookup, gather, `_prefill_paged`
    on the suffix, note_prefilled, commit, the prefix_hit event, then the
    greedy first token and its logprob. `prompt` is [1, T] on the host.
    Returns (ck, cv, block table, first token, score, outcome, reused
    tokens, suffix length); the caller owns the table's pins (an empty
    table without a cache)."""
    plen = prompt.shape[1]
    outcome, reused, match = "miss", 0, None
    if kv_cache is not None:
        match = kv_cache.lookup(prompt[0], max_tokens=plen - 1)
        outcome, reused = match.outcome, match.tokens
        prefix_k, prefix_v = kv_cache.gather(match)
    else:
        prefix_k = prefix_v = empty_prefix
    cached = int(prefix_k.shape[1])
    suffix = torch.from_numpy(prompt[:, cached:]).to(empty_prefix.device)
    last_logits, ck, cv = _prefill_paged(params, suffix, config, prefix_k,
                                         prefix_v)
    table: List[int] = []
    if kv_cache is not None:
        kv_cache.note_prefilled(suffix.shape[1])
        table = kv_cache.commit(prompt[0], ck, cv, match)
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
    """Copy a prefilled sequence's [0, plen) rows of every layer into
    batch slot `slot` of the decode slab [L, B, S, H, hd], in place."""
    slab_k[:, slot, :plen].copy_(ck[:, :plen])
    slab_v[:, slot, :plen].copy_(cv[:, :plen])


def _tick(params: Any, config: Any, cache: List[dict],
          tokens: torch.Tensor, pos_vec: torch.Tensor):
    """One greedy decode step over every slot: (next token [B], its
    logprob [B])."""
    logits, _ = _model_fns(config)[2](params, tokens, config, cache,
                                      pos_vec)
    live = logits[..., :config.vocab_size].float()
    nxt = live.argmax(dim=-1)
    lp = live.max(dim=-1).values - torch.logsumexp(live, dim=-1)
    return nxt, lp


class _Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int,
                 eos_token: Optional[int]):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.eos_token = eos_token
        self.out: "queue.Queue" = queue.Queue()
        self.produced = 0
        self.slot: Optional[int] = None
        self.cache_outcome: Optional[str] = None  # hit | partial | miss
        self.reused_tokens = 0
        self.block_table: List[int] = []
        # logprob of each emitted token, in stream order
        self.scores: List[float] = []
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
    per-block-channel scales)."""

    def __init__(self, params: Any, config: Any, *, max_batch: int = 8,
                 idle_sleep_s: float = 0.002,
                 params_version: Optional[int] = None,
                 prefix_cache: bool = True, kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, kv_int8: bool = False,
                 max_prefills_per_tick: int = 1):
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
        # admission accounting (kv_stats)
        self.prefill_calls = 0
        self.prefilled_tokens = 0
        self.spliced_tokens = 0
        self.admitted = 0
        self.prefill_admitted = 0
        self.max_prefills_admitted_per_tick = 0
        self.cancelled = 0
        # the same count by the caller's reason (deadline | disconnect |
        # preempt | ... | unspecified)
        self.cancelled_by_reason: Dict[str, int] = {}
        self._tokens = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)
        self._slot_req: List[Optional[_Request]] = [None] * max_batch
        self._free = list(range(max_batch))
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._cancels = 0  # cancelled requests not yet finished
        self._lock = threading.Lock()
        self._next_rid = 0
        self._error: Optional[BaseException] = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cb-engine")
        self._thread.start()

    # ------------------------------------------------------------- API
    def submit(self, prompt_tokens, max_new_tokens: int,
               eos_token: Optional[int] = None) -> _Request:
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        if prompt.shape[1] < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens "
                             ">= 1")
        if prompt.shape[1] + max_new_tokens > self.config.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        # an id past the embedding table would fail the gather on the loop
        # thread, and on CUDA take every live stream down with it
        if prompt.min() < 0 or prompt.max() >= self.config.vocab_size:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.config.vocab_size})")
        with self._lock:
            if self._error is not None:
                raise RuntimeError("engine decode loop failed") \
                    from self._error
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(rid, prompt, max_new_tokens, eos_token)
            self._pending.put(req)
        return req

    def stream(self, prompt_tokens, max_new_tokens: int,
               eos_token: Optional[int] = None,
               timeout_s: float = 120.0) -> TokenStream:
        """Submit and yield tokens as the shared loop produces them."""
        req = self.submit(prompt_tokens, max_new_tokens, eos_token)
        return TokenStream(req, timeout_s)

    def generate(self, prompt_tokens, max_new_tokens: int,
                 eos_token: Optional[int] = None,
                 timeout_s: float = 120.0) -> List[int]:
        return list(self.stream(prompt_tokens, max_new_tokens, eos_token,
                                timeout_s))

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
        # every cached block was computed under the old weights
        if self.kv_cache is not None:
            self.kv_cache.invalidate()
        for ev in events:
            ev.set()

    def cancel_slot(self, stream_or_req: Any,
                    reason: Optional[str] = None) -> bool:
        """Cancel a live or queued request (its TokenStream or the request
        itself): the loop frees its slot and its KV pins at the next tick
        boundary, and its stream ends. Returns False if the request had
        already finished or been cancelled. `reason` is counted in
        `cancelled_by_reason`."""
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

    def _count_cancel(self, req: _Request) -> None:
        key = req.cancel_reason or "unspecified"
        self.cancelled += 1
        self.cancelled_by_reason[key] = \
            self.cancelled_by_reason.get(key, 0) + 1

    def stop(self) -> None:
        self._stopped.set()
        self._thread.join(timeout=10.0)
        self._apply_pending_swap()  # fire waiters a stopped loop strands

    @property
    def active_slots(self) -> int:
        with self._lock:
            return self.max_batch - len(self._free)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def kv_stats(self) -> Dict[str, Any]:
        """Prefix-cache and admission counters, the JAX engine's keys for
        what this engine has. `prefill_programs` is -1: there is no
        compile cache to count."""
        s: Dict[str, Any] = (self.kv_cache.stats() if self.kv_cache
                             else {"enabled": False})
        s.update(
            engine_id=self.engine_id,
            max_batch=self.max_batch,
            max_prefills_per_tick=self.max_prefills_per_tick,
            admitted=self.admitted,
            prefill_admitted=self.prefill_admitted,
            max_prefills_admitted_per_tick=(
                self.max_prefills_admitted_per_tick),
            prefill_calls=self.prefill_calls,
            prefill_programs=-1,
            spliced_tokens=self.spliced_tokens,
            cancelled=self.cancelled,
            cancelled_by_reason=dict(self.cancelled_by_reason),
            kv_int8=self.kv_int8,
        )
        if self.kv_cache is None:
            # an uncached engine still accounts its prefill work
            s.setdefault("prefilled_tokens", self.prefilled_tokens)
            s.setdefault("reused_tokens", 0)
        return s

    # ------------------------------------------------------- admission
    def _admit(self) -> None:
        admitted = 0
        while self._free and admitted < self.max_prefills_per_tick:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            if self._admit_one(req):
                admitted += 1
        self.max_prefills_admitted_per_tick = max(
            self.max_prefills_admitted_per_tick, admitted)

    def _admit_one(self, req: _Request) -> bool:
        if req.cancelled:
            # cancelled before admission: never takes a slot
            self._count_cancel(req)
            self._finish(req)
            return False
        with self._lock:
            slot = self._free.pop()
        req.slot = slot
        self._slot_req[slot] = req
        plen = req.prompt.shape[1]
        ck, cv, table, first, score, outcome, reused, suffix_len = \
            _prefill_with_cache(self.params, self.config, self.kv_cache,
                                req.prompt, self._empty_prefix,
                                event_extra={"rid": req.rid})
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
        """Decode loop only: end a request's stream and free its slot and
        KV pins (completion, a cancel before admission and a cancel at a
        tick boundary all come here, so nothing is released twice)."""
        req.out.put(_DONE)
        slot = req.slot
        if slot is not None:
            self._slot_req[slot] = None
        if self.kv_cache is not None and req.block_table:
            self.kv_cache.release(req.block_table)
            req.block_table = []
        with self._lock:
            req.finished = True
            if slot is not None:
                self._free.append(slot)
            if req.cancelled:
                self._cancels -= 1

    def _emit(self, req: _Request, tok: int, score: float) -> None:
        req.scores.append(score)
        req.out.put(tok)
        req.produced += 1
        if (req.eos_token is not None and tok == req.eos_token) \
                or req.produced >= req.max_new:
            self._finish(req)

    def _fail(self, err: BaseException) -> None:
        """Decode loop only: hand the loop's exception to every live and
        queued request, so no stream waits for tokens that never come."""
        with self._lock:
            self._error = err
        live = [r for r in self._slot_req if r is not None]
        while True:
            try:
                live.append(self._pending.get_nowait())
            except queue.Empty:
                break
        for req in live:
            req.out.put(err)

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
        nxt, lp = _tick(self.params, self.config, self._cache,
                        torch.from_numpy(self._tokens).to(self.device),
                        torch.from_numpy(self._pos).to(self.device))
        nxt_np = nxt.cpu().numpy()
        lp_np = lp.cpu().numpy()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._pos[slot] += 1
            tok = int(nxt_np[slot])
            self._tokens[slot] = tok
            self._emit(req, tok, float(lp_np[slot]))
