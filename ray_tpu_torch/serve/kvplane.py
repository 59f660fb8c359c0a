"""Global KV plane (port of ray_tpu/serve/kvplane.py): the tiered prefix
cache, HBM -> host RAM -> object store, with a cluster-wide prefix
directory.

- **Tier 1** is the engine's paged pool on the card
  (``models/kvcache.py``).
- **Tier 2** (``HostArena``) is a bounded host-RAM arena for one
  replica's pool. A block evicted under pressure spills its int8 +
  per-block-channel-scales wire payload here instead of dying; a later
  lookup whose chain walk breaks takes it back (``take_*`` pops: a hit
  moves the block back to tier 1). LRU within a byte bound. int8 pools
  round-trip byte for byte; fp pools re-enter within the int8 tolerance.
- **Tier 3** publishes a hot prompt's block-aligned prefix as
  ``util/chunks`` objects any replica can adopt, with the conductor's
  **prefix directory**: (namespace, chain digest) -> holder and
  descriptor, an atomic commit where the first holder wins, TTL-reaped
  and keep-last-K GC'd. A directory miss falls back to the router's
  affinity hash, bit-identically.

The digests are namespace-rooted, so one tenant's spilled or published
KV can never match another tenant's prompt, in any tier.

The JAX package's knobs are arguments here, with its defaults:
``RAY_TPU_KVPLANE`` (on: ``PrefillServer(kvplane=True)``),
``RAY_TPU_KVPLANE_ARENA_BYTES`` (``ARENA_BYTES``, 128 MiB),
``RAY_TPU_KVPLANE_DIRECTORY`` (on: ``directory=True`` of the router and
the prefill server), ``RAY_TPU_KVPLANE_T3_MIN_BLOCKS`` (``T3_MIN_BLOCKS``,
2) and ``RAY_TPU_KVPLANE_T3_TTL_S`` (the conductor's
``KVPLANE_T3_TTL_S``, 600 s, or a lookup's ``ttl_s``).
``kvplane_metrics()`` is the ``ray_tpu_kvplane_*`` family on
``util.metrics``; the CLI and the dashboard wait for their ports.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


_EVENTS_KEPT = 512

ARENA_BYTES = 128 << 20
T3_MIN_BLOCKS = 2

_metrics: Optional[Dict[str, Any]] = None
_metrics_lock = threading.Lock()


def kvplane_metrics() -> Dict[str, Any]:
    """The ``ray_tpu_kvplane_*`` family on ``util.metrics`` (JAX's
    names, help and tags), created on first use."""
    global _metrics
    m = _metrics
    if m is not None:
        return m
    with _metrics_lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge

            _metrics = dict(
                hits=Counter(
                    "ray_tpu_kvplane_hits_total",
                    "prefix blocks re-adopted from a lower tier",
                    tag_keys=("tier",)),
                spills=Counter(
                    "ray_tpu_kvplane_spills_total",
                    "HBM-evicted blocks spilled into the tier-2 host "
                    "arena instead of dying"),
                evictions=Counter(
                    "ray_tpu_kvplane_evictions_total",
                    "blocks dropped OUT of a kvplane tier (arena LRU, "
                    "directory TTL/GC)",
                    tag_keys=("tier",)),
                fetched_bytes=Counter(
                    "ray_tpu_kvplane_fetched_bytes_total",
                    "wire-format bytes pulled back out of a tier on a "
                    "hit",
                    tag_keys=("tier",)),
                reused_tokens=Counter(
                    "ray_tpu_kvplane_reused_tokens_total",
                    "prompt tokens whose prefill was recovered from a "
                    "kvplane tier",
                    tag_keys=("tier",)),
                directory=Counter(
                    "ray_tpu_kvplane_directory_total",
                    "prefix-directory routing decisions",
                    tag_keys=("outcome",)),
                arena_bytes=Gauge(
                    "ray_tpu_kvplane_arena_bytes",
                    "tier-2 host-arena resident bytes"))
    return _metrics


# ------------------------------------------------------------- tier 2

class HostArena:
    """Bounded host-RAM spill arena for one replica's pool (tier 2).

    Keys are the pool's index keys, ``("full", digest)`` and
    ``("partial", parent_digest, tokens)``, their digests
    namespace-rooted. ``take_*`` pops; LRU within ``max_bytes``.
    Thread-safe: accept() runs under the pool's lock, stats() and
    drain_events() anywhere."""

    def __init__(self, max_bytes: int = ARENA_BYTES,
                 replica: Optional[str] = None):
        self.max_bytes = int(max_bytes)
        self.replica = replica
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
        # parent digest -> {tokens: key}, for the partial-tail probe
        self._partials: Dict[bytes, Dict[Tuple[int, ...], tuple]] = {}
        self._bytes = 0
        self._events: List[Dict[str, Any]] = []
        self._stats: Dict[str, int] = {
            k: 0 for k in ("spills", "spill_bytes", "tier2_hits",
                           "tier2_probes", "tier2_reused_tokens",
                           "tier2_fetched_bytes", "arena_evictions")}
        self._tl = threading.local()
        kvplane_metrics()

    @staticmethod
    def _payload_bytes(p: Dict[str, Any]) -> int:
        return int(p["qk"].nbytes + p["qv"].nbytes
                   + p["sk"].nbytes + p["sv"].nbytes)

    def _event_locked(self, ev: Dict[str, Any]) -> None:
        ev.setdefault("ts", time.time())
        if self.replica is not None:
            ev.setdefault("replica", self.replica)
        self._events.append(ev)
        if len(self._events) > _EVENTS_KEPT:
            del self._events[:len(self._events) - _EVENTS_KEPT]

    def _insert_locked(self, key: tuple, payload: Dict[str, Any],
                       size: int) -> None:
        self._entries[key] = payload
        self._entries.move_to_end(key)
        self._bytes += size
        if key[0] == "partial":
            self._partials.setdefault(key[1], {})[key[2]] = key
        while self._bytes > self.max_bytes and self._entries:
            old_key, old = self._entries.popitem(last=False)
            self._bytes -= self._payload_bytes(old)
            self._drop_partial_locked(old_key)
            self._stats["arena_evictions"] += 1
            kvplane_metrics()["evictions"].inc(tags={"tier": "2"})

    def _drop_partial_locked(self, key: tuple) -> None:
        if key[0] != "partial":
            return
        by_tok = self._partials.get(key[1])
        if by_tok is not None:
            by_tok.pop(key[2], None)
            if not by_tok:
                del self._partials[key[1]]

    def accept(self, payload: Dict[str, Any]) -> None:
        """Spill sink: an evicted block's payload enters the arena (an
        identity already here is refreshed). A payload larger than the
        arena is refused."""
        key = payload.get("index_key")
        if key is None:
            return
        size = self._payload_bytes(payload)
        if size > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= self._payload_bytes(old)
                self._drop_partial_locked(key)
            self._insert_locked(key, payload, size)
            self._stats["spills"] += 1
            self._stats["spill_bytes"] += size
            self._event_locked({"kind": "spill",
                                "block_tokens": payload.get("filled"),
                                "nbytes": size,
                                "namespace": payload.get("ns")})
            resident = self._bytes
        m = kvplane_metrics()
        m["spills"].inc()
        m["arena_bytes"].set(resident)

    def give_back(self, payload: Dict[str, Any]) -> None:
        """Return a popped payload whose re-adoption failed (no block
        free): not a spill, no counter moves."""
        key = payload.get("index_key")
        if key is None:
            return
        with self._lock:
            if key not in self._entries:
                self._insert_locked(key, payload,
                                    self._payload_bytes(payload))

    def _hit_locked(self, key: tuple, payload: Dict[str, Any],
                    t0: float) -> Dict[str, Any]:
        size = self._payload_bytes(payload)
        self._bytes -= size
        self._drop_partial_locked(key)
        filled = int(payload["filled"])
        self._stats["tier2_hits"] += 1
        self._stats["tier2_reused_tokens"] += filled
        self._stats["tier2_fetched_bytes"] += size
        self._event_locked({"kind": "tier2_hit", "block_tokens": filled,
                            "nbytes": size, "namespace": payload.get("ns")})
        acc = getattr(self._tl, "acc", None)
        if acc is not None:
            acc["blocks"] += 1
            acc["tokens"] += filled
            acc["nbytes"] += size
            acc["ms"] += (time.perf_counter() - t0) * 1e3
        m = kvplane_metrics()
        m["hits"].inc(tags={"tier": "2"})
        m["reused_tokens"].inc(filled, tags={"tier": "2"})
        m["fetched_bytes"].inc(size, tags={"tier": "2"})
        m["arena_bytes"].set(self._bytes)
        return payload

    def take_full(self, digest: bytes, blk_tokens: Tuple[int, ...]
                  ) -> Optional[Dict[str, Any]]:
        """Pop the full block keyed by `digest` iff its exact tokens
        match (a digest collision never re-adopts wrong KV)."""
        t0 = time.perf_counter()
        key = ("full", digest)
        with self._lock:
            self._stats["tier2_probes"] += 1
            payload = self._entries.get(key)
            if payload is None or payload["tokens"] != blk_tokens:
                return None
            del self._entries[key]
            return self._hit_locked(key, payload, t0)

    def take_partial(self, digest: bytes, remainder, budget: int
                     ) -> Optional[Dict[str, Any]]:
        """Pop the longest spilled partial tail under `digest` whose
        tokens prefix `remainder`, within `budget` tokens."""
        t0 = time.perf_counter()
        rem = tuple(int(t) for t in np.asarray(remainder).reshape(-1))
        with self._lock:
            self._stats["tier2_probes"] += 1
            best_key: Optional[tuple] = None
            best_len = 0
            for ptoks, key in self._partials.get(digest, {}).items():
                k = len(ptoks)
                if k > best_len and k <= budget and rem[:k] == ptoks:
                    best_key, best_len = key, k
            if best_key is None:
                return None
            payload = self._entries.pop(best_key)
            return self._hit_locked(best_key, payload, t0)

    # one request's tier-2 traffic: the lookup runs deep inside the
    # prefill, so a thread-local accumulator brackets it
    def begin_request(self) -> None:
        self._tl.acc = {"blocks": 0, "tokens": 0, "nbytes": 0, "ms": 0.0}

    def end_request(self) -> Dict[str, Any]:
        acc = getattr(self._tl, "acc", None) \
            or {"blocks": 0, "tokens": 0, "nbytes": 0, "ms": 0.0}
        self._tl.acc = None
        return acc

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
            s.update(entries=len(self._entries), bytes=self._bytes,
                     max_bytes=self.max_bytes)
        probes = s["tier2_probes"]
        s["tier2_hit_rate"] = s["tier2_hits"] / probes if probes else 0.0
        return s

    def drain_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._events = self._events, []
        return out


# ------------------------------------------------------------- tier 3

def prefix_digests(tokens, block_size: int, namespace: Optional[str] = None,
                   max_blocks: int = 32) -> List[str]:
    """The directory's keys for a prompt, longest first
    (``models.kvcache.prefix_digests``)."""
    from ..models import kvcache

    return kvcache.prefix_digests(tokens, block_size, namespace, max_blocks)


def directory_lookup(worker, namespace: Optional[str], tokens,
                     block_size: int, max_blocks: int = 32,
                     ttl_s: Optional[float] = None
                     ) -> Optional[Dict[str, Any]]:
    """Who holds the longest published prefix of `tokens`: the
    directory entry (holder, descriptor, digest), or None. Every failure
    is a None, so an outage degrades to the affinity hash. `ttl_s`
    overrides the conductor's entry TTL for this lookup."""
    digests = prefix_digests(tokens, block_size, namespace, max_blocks)
    if not digests:
        return None
    try:
        entry = worker.conductor.call("kvplane_lookup", namespace or "",
                                      digests, ttl_s, timeout=5.0)
    except Exception:  # noqa: BLE001 — directory outage
        return None
    if not isinstance(entry, dict) or entry.get("error"):
        return None
    return entry


def publish_prefix(worker, cache, tokens, namespace: Optional[str],
                   holder: str, machine: Optional[str] = None,
                   min_blocks: int = T3_MIN_BLOCKS, max_blocks: int = 32
                   ) -> Optional[Tuple[str, list]]:
    """Publish the longest cached full-block prefix of `tokens` as
    chunk-fabric objects and commit it to the prefix directory.
    Returns ``(digest_hex, refs)`` (the caller owns the refs: they are
    the objects' lifetime), or None when nothing was published."""
    from ..util import chunks

    out = cache.export_prefix(tokens, namespace, max_blocks)
    if out is None:
        return None
    packed, n_tokens, digest_hex = out
    if n_tokens < int(min_blocks) * cache.block_size:
        return None
    refs, desc = chunks.put_tree(worker, packed)
    meta = {"desc": desc, "holder": holder, "machine": machine,
            "tokens": int(n_tokens),
            "nbytes": int(desc.get("total_bytes", 0)),
            "namespace": namespace}
    res = worker.conductor.call("kvplane_publish", namespace or "",
                                digest_hex, meta, timeout=10.0)
    if not isinstance(res, dict) or res.get("error") \
            or res.get("status") == "already":
        return None  # the refs die here; the first holder keeps serving
    return digest_hex, refs


def fetch_and_adopt(worker, cache, entry: Dict[str, Any], tokens,
                    namespace: Optional[str]) -> Tuple[int, Dict[str, Any]]:
    """Pull a directory entry's tier-3 object and adopt it into `cache`:
    ``(blocks adopted, fetcher stats)``, 0 blocks on any fetch failure
    (tier 3 accelerates, it is never a dependency)."""
    from ..util import chunks

    fetcher = chunks.ChunkFetcher(worker, caller="kvplane")
    try:
        packed = chunks.fetch_tree(worker, entry["desc"], fetcher=fetcher)
    except Exception:  # noqa: BLE001 — holder gone, refs reaped, ...
        return 0, fetcher.stats()
    adopted = cache.import_prefix(tokens, packed, namespace)
    st = fetcher.stats()
    if adopted:
        m = kvplane_metrics()
        m["hits"].inc(tags={"tier": "3"})
        m["reused_tokens"].inc(adopted * cache.block_size,
                               tags={"tier": "3"})
        m["fetched_bytes"].inc(int(st.get("fetched_bytes", 0)),
                               tags={"tier": "3"})
    return adopted, st


__all__ = ["ARENA_BYTES", "HostArena", "T3_MIN_BLOCKS", "directory_lookup",
           "fetch_and_adopt", "kvplane_metrics", "prefix_digests",
           "publish_prefix"]
