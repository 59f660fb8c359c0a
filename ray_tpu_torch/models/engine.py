"""Continuous-batching generation engine, core only (port of
ray_tpu/models/engine.py).

One fixed-shape greedy decode loop over `max_batch` slots, on a thread
of its own. Every tick runs one ragged-batch decode step (per-slot
positions and masking) over all slots. A new request is prefilled into
a fresh max_seq_len cache — the same shapes as `generate()`'s prefill,
so the two agree token for token — and its [0, prompt_len) rows are
copied in place into a free slot between ticks; finished sequences (EOS
or their token budget) free their slot between ticks. Slots the engine
is not using decode rows that nothing reads.

Not ported yet (the JAX engine has them): the paged prefix cache,
speculative decoding, LoRA, adoption of remotely prefilled KV, weight
hot-swap, cancellation and telemetry.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from ..tree import tree_device
from .generate import _model_fns

_DONE = object()


def _prefill(params: Any, prompt: torch.Tensor, config: Any):
    """Prefill one sequence [1, T] into a fresh single-sequence cache.
    Returns (last-position logits [1, padded_vocab], cache)."""
    fwd, init_cache, _ = _model_fns(config)
    cache = init_cache(config, 1, device=prompt.device)
    logits, cache = fwd(params, prompt, config, cache, 0)
    return logits[:, -1], cache


def _splice_slot(cache: List[dict], filled: List[dict], slot: int,
                 plen: int) -> None:
    """Copy a prefilled sequence's [0, plen) rows into batch slot `slot`
    of the decode cache, in place: O(plen) per layer."""
    for blk, src in zip(cache, filled):
        blk["k"][slot, :plen].copy_(src["k"][0, :plen])
        blk["v"][slot, :plen].copy_(src["v"][0, :plen])


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
        # logprob of each emitted token, in stream order
        self.scores: List[float] = []


class TokenStream:
    """Iterator over one request's tokens. Raises if the engine's decode
    loop failed while the request was live."""

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
    def scores(self) -> List[float]:
        """Per-token logprobs of the tokens emitted so far."""
        return list(self._req.scores)


class ContinuousBatchingEngine:
    """Greedy continuous-batching decode over `max_batch` slots, on the
    parameters' device. At most `max_prefills_per_tick` admissions run
    between two ticks, so a burst of arrivals cannot stall every
    in-flight decode for the whole drain."""

    def __init__(self, params: Any, config: Any, *, max_batch: int = 8,
                 idle_sleep_s: float = 0.002,
                 max_prefills_per_tick: int = 1):
        self.params = params
        self.config = config
        self.max_batch = max_batch
        self.idle_sleep_s = idle_sleep_s
        self.max_prefills_per_tick = max(1, int(max_prefills_per_tick))
        self.device = tree_device(params)
        self._cache = _model_fns(config)[1](config, max_batch,
                                            device=self.device)
        self._tokens = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)
        self._slot_req: List[Optional[_Request]] = [None] * max_batch
        self._free = list(range(max_batch))
        self._pending: "queue.Queue[_Request]" = queue.Queue()
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

    def stop(self) -> None:
        self._stopped.set()
        self._thread.join(timeout=10.0)

    @property
    def active_slots(self) -> int:
        with self._lock:
            return self.max_batch - len(self._free)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    # ------------------------------------------------------- admission
    def _admit(self) -> None:
        admitted = 0
        while self._free and admitted < self.max_prefills_per_tick:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            self._admit_one(req)
            admitted += 1

    def _admit_one(self, req: _Request) -> None:
        with self._lock:
            slot = self._free.pop()
        req.slot = slot
        self._slot_req[slot] = req
        plen = req.prompt.shape[1]
        prompt = torch.from_numpy(req.prompt).to(self.device)
        last_logits, filled = _prefill(self.params, prompt, self.config)
        _splice_slot(self._cache, filled, slot, plen)
        live = last_logits[0, :self.config.vocab_size].float()
        first = int(live.argmax())
        score = float(live[first] - torch.logsumexp(live, dim=0))
        self._tokens[slot] = first
        self._pos[slot] = plen
        self._emit(req, first, score)

    def _finish(self, req: _Request) -> None:
        """Decode-loop only: end a request's stream and free its slot."""
        req.out.put(_DONE)
        slot = req.slot
        self._slot_req[slot] = None
        with self._lock:
            self._free.append(slot)

    def _emit(self, req: _Request, tok: int, score: float) -> None:
        req.scores.append(score)
        req.out.put(tok)
        req.produced += 1
        if (req.eos_token is not None and tok == req.eos_token) \
                or req.produced >= req.max_new:
            self._finish(req)

    def _fail(self, err: BaseException) -> None:
        """Decode-loop only: hand the loop's exception to every live and
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
