"""Consumer side of the live weight fabric: reshard-on-fetch (port of
ray_tpu/weights/subscriber.py).

A fetch pulls ONLY the chunks the target layout needs: each leaf's
assembly is the port's checkpoint reader (`train.async_checkpoint.
_LeafReader`) with a chunk-fetching loader, and `materialize_like`
builds the template's layout, so a DTensor template leaf reads only
this rank's block of it and a dp/fsdp training layout feeds a tp
serving layout with no full copy of a sharded leaf on any process.

Per-fetch accounting (:class:`FetchStats`) records the bytes pulled and
the largest single slice any read built, per leaf too: a consumer can
check from them that it never assembled a whole sharded leaf.
"""
from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..train.async_checkpoint import _LeafReader, materialize_like
from ..train.checkpoint import storage_dtype, to_tensor
from ..tree import tree_flatten, tree_unflatten
from ..util import chunks
from ..util.runtime import require_worker
from .metrics import weight_metrics


def _worker():
    return require_worker("fetching weights")


@dataclass
class FetchStats:
    """Accounting for one fetch() call."""

    version: int = 0
    chunks_fetched: int = 0        # pulled over the object plane
    chunks_local: int = 0          # already in this process's store
    fetched_bytes: int = 0         # bytes pulled over the object plane
    shm_bytes: int = 0             # ...of which same-host (shm path)
    rpc_bytes: int = 0             # ...of which cross-host RPC
    max_read_bytes: int = 0        # largest single assembled slice
    # per leaf: the largest single read and the whole leaf's bytes
    leaf_read_bytes: List[Any] = field(default_factory=list)
    elapsed_s: float = 0.0
    # delta-publication provenance of the fetched manifest
    delta: bool = False
    base_version: Optional[int] = None
    changed_leaves: Optional[List[int]] = None


class _ChunkFetcher(chunks.ChunkFetcher):
    """The shared chunk fetcher feeding this fetch's FetchStats: each
    needed chunk crosses the object plane at most once per fetch."""

    def __init__(self, worker, stats: FetchStats, seed_cache=None):
        def on_read(nbytes: int, was_local: bool, same_host: bool,
                    _stats=stats) -> None:
            if was_local:
                _stats.chunks_local += 1
            else:
                _stats.chunks_fetched += 1
                _stats.fetched_bytes += nbytes
                if same_host:
                    _stats.shm_bytes += nbytes
                else:
                    _stats.rpc_bytes += nbytes

        super().__init__(worker, timeout=60.0, on_read=on_read,
                         seed_cache=seed_cache, caller="weights")


class _AccountingReader(_LeafReader):
    """_LeafReader that records the size of every assembled slice."""

    def __init__(self, shape, dtype, shards, loader, stats: FetchStats,
                 leaf_index: int):
        super().__init__(None, shape, dtype, shards, loader=loader)
        self._stats = stats
        self._leaf_index = leaf_index

    def read(self, index):
        out = super().read(index)
        nbytes = int(out.nbytes)
        self._stats.max_read_bytes = max(self._stats.max_read_bytes,
                                         nbytes)
        rec = self._stats.leaf_read_bytes[self._leaf_index]
        rec["max_read_bytes"] = max(rec["max_read_bytes"], nbytes)
        return out


def _plain_leaf(arr: np.ndarray, name: str) -> Any:
    """A leaf fetched without a template: numpy, or a CPU tensor for
    bf16, which numpy cannot hold."""
    return to_tensor(arr, name) if name == chunks.BF16 else arr


class WeightSubscriber:
    """Fetches versions of one named weight set into this process.

    Rides the `weights` pubsub channel for publish notices (a registry
    poll is the fallback); :meth:`fetch` pulls a version under a target
    layout.
    """

    def __init__(self, name: str = "default", *,
                 cache_chunks: bool = False):
        self.name = name
        self._worker = _worker()
        self._cv = threading.Condition()
        self.last_stats: Optional[FetchStats] = None
        self.fetch_ms: List[float] = []
        self.fetched_bytes = 0
        # (version, {object_id: host array}): holding the arrays keeps
        # the bytes at hand for the next fetch's seed. It costs a host
        # copy of the model, so it is opt-in (cache_chunks=True, or the
        # first prefetch()).
        self._cache_chunks = bool(cache_chunks)
        self._prefetched: Optional[tuple] = None
        # guards _prefetched: a version must never clobber a newer one's
        # pulled chunks
        self._pf_lock = threading.Lock()
        self._worker.subscribe_channel("weights", self._on_weights_msg)

    def stats(self) -> Dict[str, Any]:
        """Every fetch's time and the bytes pulled over the object plane,
        with the last fetch's accounting."""
        st = self.last_stats
        return {"name": self.name, "fetches": len(self.fetch_ms),
                "fetch_ms": list(self.fetch_ms),
                "fetched_bytes": self.fetched_bytes,
                "last": None if st is None else dict(st.__dict__)}

    def _store_prefetched(self, version: int,
                          cache: Dict[str, Any]) -> None:
        """Keep pulled chunks, newest version wins: an older completion
        merges its entries under a newer holder's."""
        with self._pf_lock:
            cur = self._prefetched
            if cur is not None and cur[0] > version:
                self._prefetched = (cur[0], {**cache, **cur[1]})
            else:
                self._prefetched = (version, cache)

    def _on_weights_msg(self, msg: Any) -> None:
        """A wakeup only: waiters poll the registry again, which stays
        the one source of truth for what is committed."""
        if not isinstance(msg, dict) or msg.get("name") != self.name:
            return
        if msg.get("kind") == "published":
            with self._cv:
                self._cv.notify_all()

    # ------------------------------------------------------------ queries

    def latest_version(self) -> Optional[int]:
        """Latest committed version in the registry, or None (an O(1)
        call: no chunk tables ship)."""
        v = self._worker.conductor.call("weights_latest_version",
                                        self.name, timeout=30.0)
        return None if v is None else int(v)

    def wait_for_version(self, min_version: int,
                         timeout: float = 30.0) -> int:
        """Block until a version >= min_version is committed; returns the
        latest version. Pubsub-driven with a bounded registry poll as the
        safety net."""
        deadline = time.monotonic() + timeout
        while True:
            latest = self.latest_version()
            if latest is not None and latest >= min_version:
                return latest
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no version >= {min_version} of {self.name!r} "
                    f"within {timeout}s (latest: {latest})")
            with self._cv:
                self._cv.wait(min(remaining, 0.5))

    def _manifest(self, version: Optional[int]) -> Dict[str, Any]:
        manifest = self._worker.conductor.call(
            "weights_get_manifest", self.name, version, timeout=30.0)
        if manifest is None:
            raise KeyError(
                f"no committed version "
                f"{'(latest)' if version is None else version} "
                f"of weights {self.name!r} in the registry")
        return manifest

    @staticmethod
    def _provenance(stats: FetchStats, manifest: Dict[str, Any]) -> None:
        stats.version = int(manifest["version"])
        stats.delta = bool(manifest.get("delta"))
        stats.base_version = manifest.get("base_version")
        stats.changed_leaves = manifest.get("changed_leaves")

    # ----------------------------------------------------------- prefetch

    def prefetch(self, version: Optional[int] = None) -> FetchStats:
        """Pull `version`'s chunk bytes into this process without
        assembling any array, so a later ``fetch(like=)`` finds every
        chunk at hand. Skips chunks already held. Implies
        ``cache_chunks``. Returns the transfer accounting."""
        self._cache_chunks = True
        stats = FetchStats()
        t0 = time.perf_counter()
        manifest = self._manifest(version)
        self._provenance(stats, manifest)
        prev = self._prefetched
        fetcher = _ChunkFetcher(self._worker, stats,
                                seed_cache=prev[1] if prev else None)
        needed = set()
        for leaf in manifest["leaves"]:
            for shard in leaf["shards"]:
                needed.add(shard["object_id"])
                fetcher(shard)
        self._store_prefetched(
            stats.version, {oid: arr for oid, arr
                            in fetcher.cache.items() if oid in needed})
        stats.elapsed_s = time.perf_counter() - t0
        if stats.fetched_bytes:
            try:
                self._worker.conductor.notify("report_weight_event", {
                    "kind": "prefetch", "name": self.name,
                    "version": stats.version,
                    "fetched_bytes": stats.fetched_bytes,
                    "chunks": stats.chunks_fetched})
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        return stats

    # -------------------------------------------------------------- fetch

    def fetch(self, *, version: Optional[int] = None,
              like: Any = None) -> Any:
        """Materialize `version` (latest when None).

        ``like=template``: the template's leaves give the layout (see
        `train.async_checkpoint.materialize_like`): a DTensor leaf reads
        only this rank's block, fetching only the chunks it intersects; a
        tensor leaf is read whole onto its device in its dtype.
        ``like=None``: the producer's tree with numpy leaves (bf16 as a
        CPU tensor); this one assembles whole arrays."""
        stats = FetchStats()
        t0 = time.perf_counter()
        manifest = self._manifest(version)
        self._provenance(stats, manifest)
        prev = self._prefetched
        fetcher = _ChunkFetcher(self._worker, stats,
                                seed_cache=prev[1] if prev else None)
        machine = chunks.local_machine_id()
        readers: List[_AccountingReader] = []
        names: List[str] = []
        for i, leaf in enumerate(manifest["leaves"]):
            shape = tuple(leaf["shape"])
            dtype = storage_dtype(leaf["dtype"])
            full = int(np.prod(shape)) * dtype.itemsize if shape \
                else dtype.itemsize
            stats.leaf_read_bytes.append(
                {"leaf": i, "max_read_bytes": 0, "full_nbytes": full})
            # this host's chunks first: the reader's coverage mask then
            # skips a remote replica of a slice a local chunk filled
            shards = sorted(leaf["shards"],
                            key=lambda s: s.get("machine", "") != machine)
            names.append(leaf["dtype"])
            readers.append(_AccountingReader(shape, dtype, shards, fetcher,
                                             stats, i))
        if like is None:
            if manifest.get("treedef") is None:
                raise ValueError(
                    f"version {stats.version} of {self.name!r} carries no "
                    "tree structure (host 0's fragment lacks it); pass "
                    "like= to fetch")
            structure = pickle.loads(manifest["treedef"])
            out = tree_unflatten(structure, [
                _plain_leaf(r.read(tuple(slice(0, d) for d in r.shape)), n)
                for r, n in zip(readers, names)])
        else:
            n_like = len(tree_flatten(like)[0])
            if n_like != len(readers):
                raise ValueError(
                    f"template has {n_like} leaves but version "
                    f"{stats.version} of {self.name!r} was published with "
                    f"{len(readers)}")
            out = materialize_like(readers, names, like)
        if self._cache_chunks:
            manifest_oids = {s["object_id"]
                             for leaf in manifest["leaves"]
                             for s in leaf["shards"]}
            self._store_prefetched(
                stats.version, {oid: arr for oid, arr
                                in fetcher.cache.items()
                                if oid in manifest_oids})
        stats.elapsed_s = time.perf_counter() - t0
        self.last_stats = stats
        self.fetch_ms.append(stats.elapsed_s * 1e3)
        self.fetched_bytes += stats.fetched_bytes
        m = weight_metrics()
        m["fetches"].inc(1, tags={"name": self.name})
        if stats.fetched_bytes:
            m["fetched_bytes"].inc(stats.fetched_bytes,
                                   tags={"name": self.name})
        try:
            self._worker.conductor.notify("report_weight_event", {
                "kind": "fetch", "name": self.name,
                "version": stats.version,
                "fetched_bytes": stats.fetched_bytes,
                "chunks": stats.chunks_fetched + stats.chunks_local})
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        return out

    def close(self) -> None:
        with self._pf_lock:
            self._prefetched = None
        try:
            self._worker.unsubscribe_channel("weights",
                                             self._on_weights_msg)
        except Exception:  # noqa: BLE001 — worker already torn down
            pass
