"""Paged KV cache with hash-chained prefix reuse (port of
ray_tpu/models/kvcache.py).

One device pool per engine, K and V each ``[layers, num_blocks,
block_size, kv_heads, head_dim]`` in the model's cache dtype (int8 with
fp32 per-block-channel scales under ``int8=True``). Blocks are the unit
of sharing:

- **hash-chained index**: block ``i`` of a prompt is keyed by
  ``blake2b(chain digest of blocks < i, tokens of block i)``, the same
  digests as the JAX package's, byte for byte. Token tuples are verified
  on every match, so a digest collision never serves wrong KV. A partial
  tail block (a prompt that ends mid-block) is indexed under its parent
  digest and its exact tokens.
- **refcounts**: an admitted request pins the blocks of its matched and
  committed prefix for its lifetime; pinned blocks are never evicted or
  written. Unpinned blocks stay cached until LRU eviction under pool
  pressure takes them, leaves first.
- **copy-on-write**: a prompt that widens a cached partial block writes
  the widened block into a fresh one; the original stays indexed.
- **graceful exhaustion**: with no free or evictable block, commit stops
  caching; prefill never depends on the pool's capacity.

Device ops update the pools in place (`index_copy_`; the JAX package
donates its pools so XLA does the same): a commit touches the bytes of
the blocks it writes, never the whole pool, and writes all of one
admission's new blocks with one gather and one `index_copy_` for K and
for V. The pools are mutated on the engine's loop thread only; `stats()`
may run on any thread and reads no device tensor.

The port reads no environment knob: the JAX package's
``RAY_TPU_KV_BLOCK_SIZE`` / ``RAY_TPU_KV_POOL_BLOCKS`` / ``RAY_TPU_KV_INT8``
defaults are the arguments' defaults here.

`propose` drafts tokens for speculative decoding off the index's exact
token chains: a forward index (chain digest -> the full blocks extending
it) is kept beside the prefix index.

**Tiered KV plane** (``serve/kvplane.py``): the pool is tier 1.
``attach_arena()`` hooks a host-RAM arena into the eviction path: an
evicted block spills its wire payload (int8 K/V plus fp32
per-block-channel scales, ``_write_block_q``'s layout) to the arena
instead of dying, and a later ``lookup()`` whose chain walk breaks takes
it back through the normal insert path. An int8 pool's payload is its
bytes verbatim, so its round trip is exact and equals the JAX pool's
payload byte for byte; an fp pool quantizes on the way out and re-enters
within the int8 tolerance, as the JAX package's does.
``export_prefix()`` / ``import_prefix()`` move a whole block-aligned
prefix in the same format (tier 3, chunk-fabric objects any replica can
adopt). A payload is read off the device with one copy to the host.

``kvcache_metrics()`` is the JAX package's ``ray_tpu_kvcache_*``
family on ``util.metrics``, incremented where the JAX pool increments
it; it is created with the first pool, never at import.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

_ROOT_DIGEST = b"ray_tpu-kv-root"
_EVENTS_KEPT = 512

# ----------------------------------------------------- prometheus (lazy)
# Created with the first pool, never at import: importing the models
# starts no metrics pusher.

_metrics: Optional[Dict[str, Any]] = None
_metrics_lock = threading.Lock()


def kvcache_metrics() -> Dict[str, Any]:
    """The ``ray_tpu_kvcache_*`` family (JAX's names, help and tags)."""
    global _metrics
    m = _metrics
    if m is not None:
        return m
    with _metrics_lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge

            _metrics = dict(
                lookups=Counter(
                    "ray_tpu_kvcache_lookups_total",
                    "prefix-cache lookups at admission",
                    tag_keys=("outcome",)),
                reused_tokens=Counter(
                    "ray_tpu_kvcache_reused_tokens_total",
                    "prompt tokens served from cached KV blocks "
                    "(prefill skipped)"),
                prefilled_tokens=Counter(
                    "ray_tpu_kvcache_prefilled_tokens_total",
                    "prompt tokens actually prefilled (suffix after the "
                    "cached prefix)"),
                evictions=Counter(
                    "ray_tpu_kvcache_evictions_total",
                    "refcount-0 blocks LRU-evicted under pool pressure"),
                cow_copies=Counter(
                    "ray_tpu_kvcache_cow_copies_total",
                    "copy-on-write block copies (shared partial block "
                    "extended)"),
                utilization=Gauge(
                    "ray_tpu_kvcache_pool_utilization",
                    "fraction of pool blocks holding cached or pinned "
                    "KV"))
    return _metrics


def resolve_pool_config(config: Any, block_size: Optional[int] = 16,
                        pool_blocks: Optional[int] = 0, *, slots: int = 4,
                        int8: bool = False) -> Tuple[int, int]:
    """``(block_size, pool_blocks)``: a pool of 0 (or None) blocks is
    sized ``slots * ceil(max_seq_len / block_size)``, doubled under
    ``int8`` (an int8 block costs half the bytes); an explicit block
    count is kept as it is."""
    bs = int(block_size or 16)
    pb = int(pool_blocks or 0)
    if not pb:
        pb = slots * (-(-config.max_seq_len // bs))
        if int8:
            pb *= 2
    return bs, pb


def _chain(digest: bytes, tokens: Tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(digest, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


def _ns_root(namespace: Optional[str]) -> bytes:
    """The chain root of a cache namespace (a LoRA tenant: KV computed
    under one adapter must never match another's prompt); None is the
    plain root."""
    if namespace is None:
        return _ROOT_DIGEST
    h = hashlib.blake2b(_ROOT_DIGEST, digest_size=16)
    h.update(str(namespace).encode())
    return h.digest()


def prefix_digests(tokens, block_size: int,
                   namespace: Optional[str] = None,
                   max_blocks: int = 32) -> List[str]:
    """Hex chain digests at every full-block boundary of `tokens`,
    longest first: the keys a cluster-wide prefix directory matches."""
    tokens = np.asarray(tokens).reshape(-1)
    digest = _ns_root(namespace)
    out: List[str] = []
    for i in range(min(len(tokens) // block_size, max_blocks)):
        blk = tuple(int(t) for t in
                    tokens[i * block_size:(i + 1) * block_size])
        digest = _chain(digest, blk)
        out.append(digest.hex())
    out.reverse()
    return out


# --------------------------------------------------------- device ops
# Pools are [L, N, bs, H, hd]; `bids` is a 1-D int64 tensor of block rows
# on the pool's device and a block batch `blk` is [L, len(bids), bs, H,
# hd]. Every op writes in place and touches only the rows it names.

def _write_block(pool_k, pool_v, bids, blk_k, blk_v) -> None:
    """pool[:, bids] <- blk."""
    pool_k.index_copy_(1, bids, blk_k)
    pool_v.index_copy_(1, bids, blk_v)


def _row_mask(pool, filled_old: int) -> torch.Tensor:
    """True for the rows ``< filled_old`` of a block, broadcast over
    [L, 1, bs, H, hd]."""
    rows = torch.arange(pool.shape[2], device=pool.device)
    return (rows < filled_old)[None, None, :, None, None]


def _cow_extend_block(pool_k, pool_v, dst, src, blk_k, blk_v,
                      filled_old: int) -> None:
    """Copy-on-write into block `dst`: rows ``< filled_old`` from the
    shared block `src`, the rest from the freshly prefilled `blk`
    ([L, 1, bs, H, hd])."""
    keep = _row_mask(pool_k, filled_old)
    for pool, blk in ((pool_k, blk_k), (pool_v, blk_v)):
        pool.index_copy_(1, dst, torch.where(keep, pool.index_select(1, src),
                                             blk))


def _gather_prefix(pool_k, pool_v, bids, ntok: int):
    """A matched prefix: blocks `bids` concatenated along the token axis,
    cut to `ntok` tokens (the last block may be partial):
    ([L, ntok, H, hd] k, v)."""
    def take(pool):
        x = pool.index_select(1, bids)
        return x.reshape((x.shape[0], -1) + x.shape[3:])[:, :ntok]

    return take(pool_k), take(pool_v)


def _quantize(blk, divide: bool = False):
    """Per-block-channel symmetric int8: [..., bs, H, hd] float -> (int8
    of the same shape, fp32 scales [..., 1, H, hd]), the amax taken over
    the block's rows. A channel whose amax is 0 takes scale 1. The same
    bytes as the JAX package's jitted pool writes: XLA compiles their
    `amax / 127.0` to a product with float32(1 / 127), and `f / scale`
    to an IEEE division; both round half to even. `divide` takes the
    scale by division instead, as the JAX package's eager spill of an fp
    pool's block does."""
    f = blk.float()
    amax = f.abs().amax(dim=-3, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0 if divide
                        else amax * (1.0 / 127.0), torch.ones_like(amax))
    q = torch.round(f / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _write_block_q(pool_k, pool_v, sk, sv, bids, blk_k, blk_v) -> None:
    """Quantize-on-commit: int8 pools and scale pools [L, N, 1, H, hd]
    <- blk at block rows `bids`."""
    for pool, scales, blk in ((pool_k, sk, blk_k), (pool_v, sv, blk_v)):
        q, s = _quantize(blk)
        pool.index_copy_(1, bids, q)
        scales.index_copy_(1, bids, s)


def _cow_extend_block_q(pool_k, pool_v, sk, sv, dst, src, blk_k, blk_v,
                        filled_old: int) -> None:
    """int8 copy-on-write: the shared block's rows ``< filled_old``
    dequantized, merged with the freshly prefilled rows, and the merged
    block quantized with its own scales into `dst`."""
    keep = _row_mask(pool_k, filled_old)
    for pool, scales, blk in ((pool_k, sk, blk_k), (pool_v, sv, blk_v)):
        old = pool.index_select(1, src).float() * scales.index_select(1, src)
        q, s = _quantize(torch.where(keep, old, blk.float()))
        pool.index_copy_(1, dst, q)
        scales.index_copy_(1, dst, s)


def _write_block_qraw(pool_k, pool_v, sk, sv, bids, qk, qv, sck,
                      scv) -> None:
    """Adopt already-quantized blocks verbatim (no requantization)."""
    pool_k.index_copy_(1, bids, qk)
    pool_v.index_copy_(1, bids, qv)
    sk.index_copy_(1, bids, sck)
    sv.index_copy_(1, bids, scv)


def _gather_prefix_q(pool_k, pool_v, sk, sv, bids, ntok: int,
                     dtype: torch.dtype):
    """Dequantize-on-gather: a matched prefix out of the int8 pool, back
    in the cache dtype."""
    def take(pool, scales):
        x = (pool.index_select(1, bids).float()
             * scales.index_select(1, bids)).to(dtype)
        return x.reshape((x.shape[0], -1) + x.shape[3:])[:, :ntok]

    return take(pool_k, sk), take(pool_v, sv)


def _extract_block(ck, cv, rows, block_size: int):
    """Blocks out of a filled single-sequence cache ``[L, S, H, hd]``:
    `rows` (1-D int64, on the cache's device) lists each block's
    `block_size` token rows in turn. Returns ([L, n, bs, H, hd] k, v)."""
    def take(c):
        x = c.index_select(1, rows)
        return x.reshape((x.shape[0], -1, block_size) + x.shape[2:])

    return take(ck), take(cv)


def _host_tensor(arr: Any) -> torch.Tensor:
    """A payload array (numpy, possibly a read-only view of the object
    store) as a CPU tensor."""
    arr = np.asarray(arr)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


class PrefixMatch:
    """Result of a lookup: the pinned block table backing the longest
    cached prefix, and how many prompt tokens it covers."""

    __slots__ = ("bids", "tokens", "full_blocks", "partial_bid",
                 "partial_len", "outcome")

    def __init__(self, bids: List[int], tokens: int, full_blocks: int,
                 partial_bid: Optional[int], partial_len: int,
                 outcome: str):
        self.bids = bids
        self.tokens = tokens
        self.full_blocks = full_blocks
        self.partial_bid = partial_bid
        self.partial_len = partial_len
        self.outcome = outcome


class _Block:
    __slots__ = ("bid", "tokens", "filled", "ref", "last_used",
                 "children", "index_key", "parent_bid", "parent_digest",
                 "ns")

    def __init__(self, bid: int):
        self.bid = bid
        self.tokens: Tuple[int, ...] = ()
        self.filled = 0
        self.ref = 0
        self.last_used = 0
        self.children = 0
        # ("full", digest) | ("partial", parent_digest, tokens) | None
        # (None: dropped by invalidate() while pinned, freed on the last
        # release)
        self.index_key: Optional[tuple] = None
        self.parent_bid: Optional[int] = None
        # the chain digest this block extends (the forward index's key)
        self.parent_digest: Optional[bytes] = None
        # the cache namespace it was committed under
        self.ns: Optional[str] = None


class PagedKVCache:
    """Block-pool KV allocator and prefix index for one engine, on
    `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: Any, *, block_size: int, num_blocks: int,
                 int8: bool = False, device: Any = "cuda"):
        from .generate import _model_fns

        if block_size < 1 or num_blocks < 1:
            raise ValueError("block_size and num_blocks must be >= 1")
        self.device = resolve_device(device)
        probe = _model_fns(config)[1](config, 1, max_len=1,
                                      device=self.device)
        _, _, heads, head_dim = probe[0]["k"].shape
        self.layers = len(probe)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.dtype = probe[0]["k"].dtype
        self.int8 = bool(int8)
        shape = (self.layers, self.num_blocks, self.block_size, heads,
                 head_dim)
        pool_dtype = torch.int8 if self.int8 else self.dtype
        self._pool_k = torch.zeros(shape, dtype=pool_dtype,
                                   device=self.device)
        self._pool_v = torch.zeros_like(self._pool_k)
        if self.int8:
            sshape = (self.layers, self.num_blocks, 1, heads, head_dim)
            self._scale_k = torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
            self._scale_v = torch.zeros_like(self._scale_k)
        self._empty_k = torch.zeros((self.layers, 0, heads, head_dim),
                                    dtype=self.dtype, device=self.device)
        self._lock = threading.Lock()
        self._blocks: Dict[int, _Block] = {}
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._full_index: Dict[bytes, int] = {}
        self._partial_index: Dict[bytes, Dict[Tuple[int, ...], int]] = {}
        # the draft proposer's forward index: chain digest -> {tokens:
        # bid} of the full blocks extending it (partial tails are already
        # indexed forward by _partial_index)
        self._children: Dict[bytes, Dict[Tuple[int, ...], int]] = {}
        self._tick = itertools.count(1)
        # the tier-2 host arena (serve/kvplane.HostArena); None is the
        # single-tier pool
        self._arena: Optional[Any] = None
        self._events: List[Dict[str, Any]] = []
        self._stats: Dict[str, int] = {
            k: 0 for k in ("lookups", "hits", "partial_hits", "misses",
                           "reused_tokens", "prefilled_tokens",
                           "inserted_blocks", "evictions", "cow_copies",
                           "invalidations")}
        kvcache_metrics()  # registered before the first event

    def _utilization_locked(self) -> float:
        return 1.0 - len(self._free) / self.num_blocks

    def _index(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    # ------------------------------------------------------------ lookup

    def lookup(self, tokens, max_tokens: int,
               namespace: Optional[str] = None) -> PrefixMatch:
        """Longest cached block-aligned (+ partial tail) prefix of
        `tokens`, at most `max_tokens` long so the caller keeps a suffix
        to prefill. Matched blocks are pinned as the walk goes: pair every
        lookup with a release() of the returned or committed table, and
        pass the same `namespace` to the paired commit()."""
        tokens = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        with self._lock:
            digest = _ns_root(namespace)
            bids: List[int] = []
            matched = 0
            now = next(self._tick)
            while matched + bs <= max_tokens:
                blk = tuple(int(t) for t in tokens[matched:matched + bs])
                nxt = _chain(digest, blk)
                bid = self._full_index.get(nxt)
                if bid is None or self._blocks[bid].tokens != blk:
                    # tier 2: the block may have been evicted into the
                    # arena; take it back and keep walking
                    bid = self._from_arena_locked(
                        self._arena.take_full(nxt, blk)
                        if self._arena is not None else None,
                        bids[-1] if bids else None, now)
                    if bid is None:
                        break
                # pinned as the walk goes: an arena adoption further down
                # may evict, and an unpinned match would be a victim
                b = self._blocks[bid]
                b.ref += 1
                b.last_used = now
                bids.append(bid)
                digest = nxt
                matched += bs
            full_blocks = len(bids)
            partial_bid: Optional[int] = None
            partial_len = 0
            for ptoks, bid in self._partial_index.get(digest, {}).items():
                k = len(ptoks)
                if (k > partial_len and matched + k <= max_tokens
                        and tuple(int(t) for t in
                                  tokens[matched:matched + k]) == ptoks):
                    partial_bid, partial_len = bid, k
            if partial_bid is None and self._arena is not None:
                payload = self._arena.take_partial(
                    digest, tokens[matched:], max_tokens - matched)
                partial_bid = self._from_arena_locked(
                    payload, bids[-1] if bids else None, now)
                if partial_bid is not None:
                    partial_len = len(payload["tokens"])
            if partial_bid is not None:
                b = self._blocks[partial_bid]
                b.ref += 1
                b.last_used = now
                bids.append(partial_bid)
                matched += partial_len
            if matched and len(tokens) - matched <= bs:
                outcome = "hit"
                self._stats["hits"] += 1
            elif matched:
                outcome = "partial"
                self._stats["partial_hits"] += 1
            else:
                outcome = "miss"
                self._stats["misses"] += 1
            self._stats["lookups"] += 1
            self._stats["reused_tokens"] += matched
        m = kvcache_metrics()
        m["lookups"].inc(tags={"outcome": outcome})
        if matched:
            m["reused_tokens"].inc(matched)
        return PrefixMatch(bids, matched, full_blocks, partial_bid,
                           partial_len, outcome)

    def gather(self, match: PrefixMatch):
        """The matched prefix on the device, ``([L, tokens, H, hd] k,
        v)`` in the cache dtype (empty for a miss)."""
        if match.tokens == 0:
            return self._empty_k, self._empty_k
        bids = self._index(match.bids)
        with self._lock:
            if self.int8:
                return _gather_prefix_q(self._pool_k, self._pool_v,
                                        self._scale_k, self._scale_v, bids,
                                        match.tokens, self.dtype)
            return _gather_prefix(self._pool_k, self._pool_v, bids,
                                  match.tokens)

    # ------------------------------------------------ tiered KV plane

    def attach_arena(self, arena: Optional[Any]) -> None:
        """Hook a tier-2 host arena (serve/kvplane.HostArena) into the
        pool: evictions spill to ``arena.accept()``, and a broken lookup
        walk asks ``arena.take_full()`` / ``take_partial()`` before
        giving up. None detaches it."""
        with self._lock:
            self._arena = arena

    def _payloads_locked(self, blocks: List[_Block]) -> List[Dict[str, Any]]:
        """The tier-2/3 wire payload of each block: int8 K/V [L, bs, H,
        hd] and fp32 scales [L, 1, H, hd] on the host (all blocks in one
        copy off the device) plus the index identity to re-adopt it. An
        int8 pool hands out its bytes verbatim; an fp pool quantizes."""
        bids = self._index([b.bid for b in blocks])
        if self.int8:
            parts = [x.index_select(1, bids).cpu().numpy() for x in (
                self._pool_k, self._pool_v, self._scale_k, self._scale_v)]
        else:
            qk, sk = _quantize(self._pool_k.index_select(1, bids), True)
            qv, sv = _quantize(self._pool_v.index_select(1, bids), True)
            parts = [x.cpu().numpy() for x in (qk, qv, sk, sv)]
        return [{"index_key": b.index_key, "tokens": b.tokens,
                 "filled": b.filled, "ns": b.ns,
                 "parent_digest": b.parent_digest,
                 **{name: np.ascontiguousarray(part[:, i])
                    for name, part in zip(("qk", "qv", "sk", "sv"), parts)}}
                for i, b in enumerate(blocks)]

    def _adopt_payload_locked(self, payload: Dict[str, Any],
                              parent: Optional[int],
                              now: int) -> Optional[int]:
        """Re-adopt a wire payload through the normal insert path. Returns
        the new bid, unpinned, or None when no block could be allocated
        (the caller gives the payload back to its tier)."""
        key = payload.get("index_key")
        if key is None:
            return None
        bid = self._alloc_locked()
        if bid is None:
            return None
        dst = self._index([bid])
        q = [_host_tensor(payload[f])[:, None].to(self.device)
             for f in ("qk", "qv", "sk", "sv")]
        if self.int8:
            _write_block_qraw(self._pool_k, self._pool_v, self._scale_k,
                              self._scale_v, dst, *q)
        else:
            _write_block(self._pool_k, self._pool_v, dst,
                         (q[0].float() * q[2]).to(self.dtype),
                         (q[1].float() * q[3]).to(self.dtype))
        self._insert_locked(bid, key, payload["tokens"], payload["filled"],
                            parent, now, payload.get("ns"),
                            payload.get("parent_digest"))
        self._blocks[bid].ref = 0
        return bid

    def _from_arena_locked(self, payload: Optional[Dict[str, Any]],
                           parent: Optional[int], now: int) -> Optional[int]:
        """Adopt a payload the arena handed out, or give it back when no
        block is free."""
        if payload is None:
            return None
        bid = self._adopt_payload_locked(payload, parent, now)
        if bid is None:
            self._arena.give_back(payload)
        return bid

    def export_prefix(self, tokens, namespace: Optional[str] = None,
                      max_blocks: int = 32
                      ) -> Optional[Tuple[Dict[str, Any], int, str]]:
        """The longest cached full-block chain prefix of `tokens` in the
        tier-3 wire format: ``(packed, n_tokens, digest_hex)``, packed =
        stacked int8 blocks and scales plus the exact token prefix, the
        digest the prefix directory keys it by; None when nothing is
        cached. Nothing is pinned: tier 3 holds a copy."""
        tokens = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        chain: List[_Block] = []
        with self._lock:
            digest = _ns_root(namespace)
            matched = 0
            while matched + bs <= len(tokens) and len(chain) < max_blocks:
                blk = tuple(int(t) for t in tokens[matched:matched + bs])
                nxt = _chain(digest, blk)
                bid = self._full_index.get(nxt)
                if bid is None or self._blocks[bid].tokens != blk:
                    break
                chain.append(self._blocks[bid])
                digest = nxt
                matched += bs
            if not chain:
                return None
            payloads = self._payloads_locked(chain)
        packed = {f: np.stack([p[f] for p in payloads])
                  for f in ("qk", "qv", "sk", "sv")}
        packed["tokens"] = np.asarray(tokens[:matched], np.int64)
        return packed, matched, digest.hex()

    def import_prefix(self, tokens, packed: Dict[str, Any],
                      namespace: Optional[str] = None) -> int:
        """Adopt a tier-3 packed prefix (``export_prefix``'s format) into
        this pool's index, unpinned; blocks already cached are skipped.
        Returns the number of blocks adopted. The packed tokens must be a
        prefix of `tokens`, or nothing is adopted."""
        tokens = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        ptoks = np.asarray(packed["tokens"]).reshape(-1)
        if len(ptoks) > len(tokens) \
                or not np.array_equal(tokens[:len(ptoks)], ptoks):
            return 0
        adopted: List[int] = []
        with self._lock:
            digest = _ns_root(namespace)
            now = next(self._tick)
            parent: Optional[int] = None
            for i in range(int(np.shape(packed["qk"])[0])):
                if (i + 1) * bs > len(ptoks):
                    break
                blk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                nxt = _chain(digest, blk)
                bid = self._full_index.get(nxt)
                if bid is not None and self._blocks[bid].tokens == blk:
                    parent, digest = bid, nxt
                    continue
                bid = self._adopt_payload_locked(
                    {"index_key": ("full", nxt), "tokens": blk,
                     "filled": bs, "ns": namespace, "parent_digest": digest,
                     **{f: packed[f][i] for f in ("qk", "qv", "sk", "sv")}},
                    parent, now)
                if bid is None:
                    break
                # pinned while the loop runs: a later adoption's alloc
                # must not evict an earlier adopted leaf
                self._blocks[bid].ref = 1
                adopted.append(bid)
                parent, digest = bid, nxt
            for bid in adopted:
                self._blocks[bid].ref = 0
            util = self._utilization_locked()
        kvcache_metrics()["utilization"].set(util)
        return len(adopted)

    def force_evict(self, n: int) -> int:
        """Evict up to `n` unpinned leaf blocks in LRU order, whatever
        the pool's pressure (the chaos ``evict_storm``; with an arena
        attached every victim spills). Returns how many went."""
        evicted = 0
        with self._lock:
            for _ in range(int(n)):
                victim = self._victim_locked()
                if victim is None:
                    break
                self._evict_locked(victim)
                self._free.append(victim.bid)
                evicted += 1
            util = self._utilization_locked()
        kvcache_metrics()["utilization"].set(util)
        return evicted

    # ----------------------------------------------------------- propose

    def propose(self, tokens, k: int,
                namespace: Optional[str] = None) -> List[int]:
        """Draft up to `k` tokens continuing `tokens` off the index's exact
        token chains (prompt-lookup speculative decoding): walk the chain
        of the context's block-aligned prefix, then follow the full blocks
        (and last a partial tail) whose tokens extend the rest of it.
        Returns [] when no cached chain extends the context. Nothing is
        pinned: a wrong draft is rejected by the verify step."""
        tokens = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        n = len(tokens)
        out: List[int] = []
        with self._lock:
            digest = _ns_root(namespace)
            matched = 0
            while matched + bs <= n:
                blk = tuple(int(t) for t in tokens[matched:matched + bs])
                nxt = _chain(digest, blk)
                bid = self._full_index.get(nxt)
                if bid is None or self._blocks[bid].tokens != blk:
                    break
                digest = nxt
                matched += bs
            rem = tuple(int(t) for t in tokens[matched:])
            if len(rem) >= bs:
                return []  # the context left every cached chain
            while len(out) < k:
                step = next(((toks, bid) for toks, bid
                             in self._children.get(digest, {}).items()
                             if toks[:len(rem)] == rem
                             and len(toks) > len(rem)), None)
                if step is None:
                    break
                toks, bid = step
                out.extend(toks[len(rem):])
                key = self._blocks[bid].index_key
                if key is None or key[0] != "full":
                    break
                digest, rem = key[1], ()
            if len(out) < k:
                # the longest partial tail extending what is left
                best: Tuple[int, ...] = ()
                for toks in self._partial_index.get(digest, {}):
                    if toks[:len(rem)] == rem and len(toks) > len(rem) \
                            and len(toks) > len(best):
                        best = toks
                out.extend(best[len(rem):])
        return out[:k]

    # ------------------------------------------------------------ commit

    def note_prefilled(self, n_tokens: int) -> None:
        with self._lock:
            self._stats["prefilled_tokens"] += int(n_tokens)
        kvcache_metrics()["prefilled_tokens"].inc(int(n_tokens))

    def commit(self, tokens, ck, cv, match: PrefixMatch,
               namespace: Optional[str] = None) -> List[int]:
        """Insert the prompt's uncached blocks from its freshly filled
        single-sequence cache ``ck, cv [L, S, H, hd]`` and return the
        request's pinned block table (matched + inserted). Stops quietly
        when the pool is exhausted: caching is best effort, the slot's
        own rows are already right. All plain block writes of the call go
        to the device together; at most one block is a copy-on-write."""
        tokens = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        n_full, tail = divmod(len(tokens), bs)
        # (bid, first token row) of each plain write; (bid, first row,
        # shared rows, shared block) of the copy-on-write
        writes: List[Tuple[int, int]] = []
        cows: List[Tuple[int, int, int, int]] = []
        with self._lock:
            table = list(match.bids)
            digest = _ns_root(namespace)
            now = next(self._tick)
            parent: Optional[int] = None
            exhausted = False
            for i in range(n_full):
                blk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                nxt = _chain(digest, blk)
                if i < match.full_blocks:
                    parent, digest = match.bids[i], nxt
                    continue
                existing = self._full_index.get(nxt)
                if (existing is not None
                        and self._blocks[existing].tokens == blk):
                    b = self._blocks[existing]
                    b.ref += 1
                    b.last_used = now
                    table.append(existing)
                    parent, digest = existing, nxt
                    continue
                bid = self._alloc_locked()
                if bid is None:
                    exhausted = True
                    break
                if i == match.full_blocks and match.partial_bid is not None:
                    # this prompt widens the matched shared partial block
                    # to a full one: copy-on-write, the original stays
                    # indexed for shorter matches
                    cows.append((bid, i * bs, match.partial_len,
                                 match.partial_bid))
                else:
                    writes.append((bid, i * bs))
                self._insert_locked(bid, ("full", nxt), blk, bs, parent,
                                    now, namespace, digest)
                table.append(bid)
                parent, digest = bid, nxt
            if tail and not exhausted:
                self._commit_tail_locked(tokens, ck.shape[1], match, digest,
                                         parent, n_full, tail, table, now,
                                         namespace, writes, cows)
            self._write_locked(ck, cv, writes, cows)
            util = self._utilization_locked()
        kvcache_metrics()["utilization"].set(util)
        return table

    def _commit_tail_locked(self, tokens, window: int, match, digest,
                            parent, n_full, tail, table, now, namespace,
                            writes, cows) -> None:
        bs = self.block_size
        if (n_full + 1) * bs > window:
            # the tail block's extent crosses the cache window
            # (block_size not dividing max_seq_len): not cached
            return
        tail_toks = tuple(int(t) for t in tokens[n_full * bs:])
        # the matched partial precedes the tail only when it sat at the
        # last block position (else the loop above widened it)
        tail_partial = (match.partial_bid
                        if match.full_blocks == n_full else None)
        if tail_partial is not None and match.partial_len == tail:
            return  # the matched partial already covers the whole tail
        existing = self._partial_index.get(digest, {}).get(tail_toks)
        if existing is not None:
            b = self._blocks[existing]
            b.ref += 1
            b.last_used = now
            table.append(existing)
            return
        bid = self._alloc_locked()
        if bid is None:
            return
        if tail_partial is not None:
            cows.append((bid, n_full * bs, match.partial_len, tail_partial))
        else:
            writes.append((bid, n_full * bs))
        self._insert_locked(bid, ("partial", digest, tail_toks), tail_toks,
                            tail, parent, now, namespace, digest)
        table.append(bid)

    def _device_index(self, bids, starts):
        """Block rows `bids` and the token rows of the blocks that start
        at `starts`, on the device in one upload."""
        rows = (np.asarray(starts, np.int64)[:, None]
                + np.arange(self.block_size)).reshape(-1)
        idx = self._index(np.concatenate([np.asarray(bids, np.int64), rows]))
        return idx[:len(bids)], idx[len(bids):]

    def _write_locked(self, ck, cv, writes, cows) -> None:
        """The device side of one commit: the plain block writes as one
        gather and one `index_copy_` for K and for V (the int8 pool
        quantizes on the way in), then the copy-on-write block."""
        bs = self.block_size
        pools = (self._pool_k, self._pool_v)
        scales = (self._scale_k, self._scale_v) if self.int8 else ()
        if writes:
            dst, rows = self._device_index([w[0] for w in writes],
                                           [w[1] for w in writes])
            bk, bv = _extract_block(ck, cv, rows, bs)
            if self.int8:
                _write_block_q(*pools, *scales, dst, bk, bv)
            else:
                _write_block(*pools, dst, bk, bv)
        for dst_bid, start, filled_old, src_bid in cows:
            pair, rows = self._device_index([dst_bid, src_bid], [start])
            bk, bv = _extract_block(ck, cv, rows, bs)
            if self.int8:
                _cow_extend_block_q(*pools, *scales, pair[:1], pair[1:], bk,
                                    bv, filled_old)
            else:
                _cow_extend_block(*pools, pair[:1], pair[1:], bk, bv,
                                  filled_old)
            self._stats["cow_copies"] += 1
            kvcache_metrics()["cow_copies"].inc()

    def _insert_locked(self, bid: int, index_key: tuple,
                       blk_tokens: Tuple[int, ...], filled: int,
                       parent: Optional[int], now: int,
                       ns: Optional[str] = None,
                       parent_digest: Optional[bytes] = None) -> None:
        b = _Block(bid)
        b.tokens = blk_tokens
        b.filled = filled
        b.ref = 1  # the committing request's pin
        b.last_used = now
        b.index_key = index_key
        b.parent_bid = parent
        b.parent_digest = parent_digest
        b.ns = ns
        self._blocks[bid] = b
        if index_key[0] == "full":
            self._full_index[index_key[1]] = bid
            if parent_digest is not None:
                self._children.setdefault(parent_digest,
                                          {})[blk_tokens] = bid
        else:
            self._partial_index.setdefault(index_key[1],
                                           {})[index_key[2]] = bid
        if parent is not None and parent in self._blocks:
            self._blocks[parent].children += 1
        self._stats["inserted_blocks"] += 1

    # -------------------------------------------------- alloc / evict

    def _victim_locked(self) -> Optional[_Block]:
        """The least recently used unpinned leaf (children of unpinned
        interiors are unpinned too, so leaves drain first)."""
        victim: Optional[_Block] = None
        for b in self._blocks.values():
            if b.ref == 0 and b.children == 0 and b.index_key is not None:
                if victim is None or b.last_used < victim.last_used:
                    victim = b
        return victim

    def _alloc_locked(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim = self._victim_locked()
        if victim is None:
            return None
        self._evict_locked(victim)
        return victim.bid

    def _evict_locked(self, b: _Block) -> None:
        # tier-2 spill before the index drop: the payload carries the
        # block's index identity, and accept() touches host memory only
        if self._arena is not None and b.index_key is not None:
            try:
                self._arena.accept(self._payloads_locked([b])[0])
            except Exception:  # noqa: BLE001 — a spill is best effort
                pass
        self._drop_index_locked(b)
        if b.parent_bid is not None and b.parent_bid in self._blocks:
            self._blocks[b.parent_bid].children -= 1
        del self._blocks[b.bid]
        self._stats["evictions"] += 1
        kvcache_metrics()["evictions"].inc()
        self._event_locked({"kind": "evict", "bid": b.bid,
                            "block_tokens": b.filled})

    def _drop_index_locked(self, b: _Block) -> None:
        key = b.index_key
        if key is None:
            return
        if key[0] == "full":
            self._full_index.pop(key[1], None)
            if b.parent_digest is not None:
                kids = self._children.get(b.parent_digest)
                if kids is not None:
                    kids.pop(b.tokens, None)
                    if not kids:
                        del self._children[b.parent_digest]
        else:
            by_tok = self._partial_index.get(key[1])
            if by_tok is not None:
                by_tok.pop(key[2], None)
                if not by_tok:
                    del self._partial_index[key[1]]
        b.index_key = None

    # ---------------------------------------------------- release / gc

    def release(self, table: List[int]) -> None:
        """Drop a finished request's pins. Unpinned blocks stay cached;
        blocks dropped from the index while pinned are freed."""
        with self._lock:
            for bid in table:
                b = self._blocks.get(bid)
                if b is None:
                    continue
                b.ref = max(0, b.ref - 1)
                if b.ref == 0 and b.index_key is None:
                    if b.parent_bid is not None \
                            and b.parent_bid in self._blocks:
                        self._blocks[b.parent_bid].children -= 1
                    del self._blocks[b.bid]
                    self._free.append(b.bid)
            util = self._utilization_locked()
        kvcache_metrics()["utilization"].set(util)

    def invalidate(self, namespace: Optional[str] = ...) -> None:
        """Drop the whole index (a weight swap: every block's KV was
        computed under the old weights), or with ``namespace=`` only that
        namespace's blocks. Pinned blocks stay allocated until their last
        release; unpinned ones are freed now."""
        scoped = namespace is not ...
        with self._lock:
            for b in list(self._blocks.values()):
                if scoped and b.ns != namespace:
                    continue
                self._drop_index_locked(b)
                if b.ref == 0:
                    if scoped and b.parent_bid is not None \
                            and b.parent_bid in self._blocks:
                        self._blocks[b.parent_bid].children -= 1
                    del self._blocks[b.bid]
                    self._free.append(b.bid)
            if not scoped:
                for b in self._blocks.values():
                    b.children = 0
            self._stats["invalidations"] += 1
            ev: Dict[str, Any] = {"kind": "invalidate"}
            if scoped:
                ev["namespace"] = namespace
            self._event_locked(ev)
            util = self._utilization_locked()
        kvcache_metrics()["utilization"].set(util)

    # -------------------------------------------------- stats / events

    def _event_locked(self, ev: Dict[str, Any]) -> None:
        ev.setdefault("ts", time.time())
        self._events.append(ev)
        if len(self._events) > _EVENTS_KEPT:
            del self._events[:len(self._events) - _EVENTS_KEPT]

    def record_event(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._event_locked(dict(ev))

    def drain_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._events = self._events, []
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
            cached = sum(1 for b in self._blocks.values()
                         if b.index_key is not None)
            pinned = sum(1 for b in self._blocks.values() if b.ref > 0)
            s.update(
                enabled=True,
                block_size=self.block_size,
                num_blocks=self.num_blocks,
                free_blocks=len(self._free),
                cached_blocks=cached,
                pinned_blocks=pinned,
                pool_utilization=self._utilization_locked(),
                int8=self.int8,
                # bytes-per-block capacity against an fp pool
                capacity_factor=2 if self.int8 else 1,
                pool_bytes=int(self._pool_k.nbytes + self._pool_v.nbytes
                               + ((self._scale_k.nbytes
                                   + self._scale_v.nbytes)
                                  if self.int8 else 0)),
            )
        looked = s["lookups"]
        s["hit_rate"] = ((s["hits"] + s["partial_hits"]) / looked
                         if looked else 0.0)
        seen = s["reused_tokens"] + s["prefilled_tokens"]
        s["token_reuse_rate"] = s["reused_tokens"] / seen if seen else 0.0
        return s
