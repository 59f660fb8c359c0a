"""Producer side of the live weight fabric (port of
ray_tpu/weights/publisher.py).

Each process of a training gang publishes ONLY its own shards; there is
never a gather. A `DTensor` leaf contributes its local block where this
rank holds its replica 0, at the block's true global offset (the same
snapshot the port's checkpoints take, `train.async_checkpoint.
_leaf_snapshots`); a plain tensor or any other value is one shard,
published by process 0. Each shard goes into THIS process's object
store as one chunk (a CUDA tensor copied to the host once, bf16 as its
uint16 bits), and a metadata-only fragment rides one RPC to the
conductor's version registry, which commits the version when the LAST
host's fragment lands: a subscriber never sees a torn publish.

The chunks live exactly as long as the publishing process: publish from
a process that outlives consumption (the spmd driver, a long-lived
gang).

GC: the registry's keep-last-K (and the reaping of torn publishes)
notifies producers on the `weights` pubsub channel with the object ids
it dropped; the publisher drops its refs for them and the refcount layer
frees the store entries.
"""
from __future__ import annotations

import hashlib
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..train.async_checkpoint import _leaf_snapshots, _process
from ..tree import tree_flatten
from ..util import chunks
from ..util.runtime import require_worker
from .metrics import weight_metrics


def _worker():
    return require_worker("publishing weights")


def _hash_snapshot(meta: Dict[str, Any],
                   shards: List[Tuple[tuple, Any]]) -> str:
    """Content hash of one leaf's host-local snapshot (blake2b over each
    shard's index and bytes, plus shape and dtype, so a reshaped
    same-bytes leaf never reads as unchanged). bf16 hashes its bits."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((meta["shape"], meta["dtype"])).encode())
    for index, host_arr in shards:
        h.update(repr(index).encode())
        h.update(chunks.ensure_chunkable(host_arr).data)
    return h.hexdigest()


def leaf_content_hashes(tree: Any) -> List[str]:
    """Per-leaf content hash of THIS process's shards, leaves in JAX's
    order: two publishes of a leaf hash equal iff this process's share of
    it is bit-identical (the delta publication's change detector)."""
    leaves, _ = tree_flatten(tree)
    return [_hash_snapshot(*_leaf_snapshots(leaf)) for leaf in leaves]


class WeightPublisher:
    """Publishes versions of one named weight set from this process.

    host_rank / num_hosts default to this process's rank and world size
    in the default process group (0 and 1 without one), so a gang where
    every rank constructs a publisher and publishes the same step
    commits one joint version made of every rank's shards."""

    def __init__(self, name: str = "default", *,
                 host_rank: Optional[int] = None,
                 num_hosts: Optional[int] = None):
        rank, world = _process()
        self.name = name
        self.host_rank = rank if host_rank is None else int(host_rank)
        self.num_hosts = world if num_hosts is None else int(num_hosts)
        self._worker = _worker()
        # version -> chunk refs: holding them IS the chunks' lifetime.
        # With delta publication a chunk can be referenced by manifests
        # newer than its own version; gc notices name explicit object
        # ids, so refs held under an old version keep pinning exactly
        # the chunks that are live.
        self._refs: Dict[int, List[Any]] = {}
        # delta base: the per-leaf hashes of this process's share of the
        # last publish that committed from this publisher
        self._last_version: Optional[int] = None
        self._last_hashes: Optional[List[str]] = None
        self._lock = threading.Lock()
        self.publish_ms: List[float] = []
        self.published_bytes: List[int] = []
        self._worker.subscribe_channel("weights", self._on_weights_msg)

    def stats(self) -> Dict[str, Any]:
        """This publisher's numbers: each publish's latency (shards into
        the store and the registry's commit) and bytes put."""
        return {"name": self.name, "host_rank": self.host_rank,
                "num_hosts": self.num_hosts,
                "published": len(self.publish_ms),
                "publish_ms": list(self.publish_ms),
                "published_bytes": list(self.published_bytes),
                "held_versions": self.held_versions()}

    # ------------------------------------------------------------- publish

    def publish(self, tree: Any, *, step: Optional[int] = None,
                version: Optional[int] = None, run_id: str = "",
                delta: bool = False) -> int:
        """Publish this process's shards of `tree` as `version` (default
        `step`, else the registry's latest + 1; a gang must pass a step
        so every rank names the same version). Returns the version id;
        it is fetchable once every host committed.

        ``delta=True`` ships only the leaves whose content hash changed
        since this publisher's previous publish (the base version); the
        unchanged leaves inherit the base manifest's chunk entries at
        commit. With no base (the first publish, or the base was GC'd) it
        publishes in full."""
        t0 = time.perf_counter()
        if version is None:
            if step is None:
                if self.num_hosts > 1:
                    # registry-assigned numbering races across hosts: two
                    # hosts in different rounds could name one version
                    raise ValueError(
                        "multi-host publishes need an explicit step= "
                        "(every host must name the same version)")
                version = self._next_version()
            else:
                version = step
        version = int(version)
        # a restarted attempt replaying a published step must not pay the
        # shard copy only to be rejected (the registry stays the judge)
        try:
            exists = self._worker.conductor.call(
                "weights_has_version", self.name, version, timeout=10.0)
        except Exception:  # noqa: BLE001 — probe only
            exists = False
        if exists:
            raise ValueError(
                f"weight publish rejected: version {version} of "
                f"{self.name!r} is already committed")
        leaves, structure = tree_flatten(tree)
        # snapshot once; hash only on delta publishes
        snaps = [_leaf_snapshots(leaf) for leaf in leaves]
        hashes = [_hash_snapshot(meta, shards)
                  for meta, shards in snaps] if delta else None
        base_version: Optional[int] = None
        base_hashes: Optional[List[str]] = None
        if delta and self._last_version is not None \
                and self._last_hashes is not None \
                and len(self._last_hashes) == len(leaves):
            base_version = self._last_version
            base_hashes = self._last_hashes
            try:
                if not self._worker.conductor.call(
                        "weights_has_version", self.name, base_version,
                        timeout=10.0):
                    base_version = base_hashes = None  # aged out
            except Exception:  # noqa: BLE001 — probe only; the commit
                pass           # checks again under its lock
        frag_leaves: Dict[str, Any] = {}
        refs: List[Any] = []
        nbytes = 0
        w = self._worker
        for i, (meta, shards) in enumerate(snaps):
            if base_hashes is not None and hashes[i] == base_hashes[i]:
                # unchanged since the base: metadata only
                frag_leaves[str(i)] = {**meta, "hash": hashes[i],
                                       "from_base": True, "shards": []}
                continue
            entries = []
            for index, host_arr in shards:
                ref, entry = chunks.put_chunk(w, host_arr)
                refs.append(ref)
                nbytes += entry["nbytes"]
                entries.append(dict(entry, index=[list(t) for t in index]))
            frag_leaves[str(i)] = {**meta,
                                   "hash": hashes[i] if hashes else None,
                                   "shards": entries}
        fragment: Dict[str, Any] = {"leaves": frag_leaves,
                                    "n_leaves": len(leaves)}
        if base_version is not None:
            fragment["base_version"] = base_version
        if self.host_rank == 0:
            fragment["treedef"] = pickle.dumps(structure, protocol=5)
        with self._lock:
            self._refs.setdefault(version, []).extend(refs)
        try:
            res = w.conductor.call(
                "weights_publish_fragment", self.name, version,
                self.host_rank, self.num_hosts, fragment, run_id, step,
                timeout=60.0)
        except Exception:
            # ambiguous: the fragment may have landed before the timeout.
            # Only refs of a fragment that verifiably never landed are
            # dropped here; otherwise gc / reap notices release them.
            if not self._fragment_landed(version):
                self._drop_call_refs(version, refs)
            raise
        if res.get("error"):
            self._drop_call_refs(version, refs)
            if "delta base" in res["error"]:
                # the base was GC'd between the probe and the commit:
                # publish in full, and seed the chain with this tree's
                # hashes
                self._last_version = self._last_hashes = None
                v = self.publish(tree, step=step, version=version,
                                 run_id=run_id, delta=False)
                self._last_version = v
                self._last_hashes = hashes
                return v
            raise ValueError(f"weight publish rejected: {res['error']}")
        if hashes is not None:
            self._last_version = version
            self._last_hashes = hashes
        ms = (time.perf_counter() - t0) * 1e3
        self.publish_ms.append(ms)
        self.published_bytes.append(nbytes)
        m = weight_metrics()
        m["publish_ms"].observe(ms, tags={"name": self.name})
        m["published"].inc(1, tags={"name": self.name})
        return version

    def _fragment_landed(self, version: int) -> bool:
        """Did the registry record `version` (pending or committed)? An
        unreachable registry reads as True: keeping refs until close()
        (a bounded leak) beats freeing chunks a manifest may use."""
        try:
            listing = self._worker.conductor.call("get_weight_versions",
                                                  timeout=10.0)
        except Exception:  # noqa: BLE001 — conductor unreachable
            return True
        rec = (listing.get("names") or {}).get(self.name)
        if rec and any(v["version"] == version for v in rec["versions"]):
            return True
        return any(p.get("name") == self.name
                   and p.get("version") == version
                   for p in listing.get("pending") or ())

    def _drop_call_refs(self, version: int, refs: List[Any]) -> None:
        """Drop ONLY this call's refs: a duplicate-version publish must
        not free the chunks of the committed version of that number."""
        with self._lock:
            held = self._refs.get(version)
            if held is None:
                return
            mine = {r.id for r in refs}
            held[:] = [r for r in held if r.id not in mine]
            if not held:
                del self._refs[version]

    def _next_version(self) -> int:
        listing = self._worker.conductor.call("get_weight_versions",
                                              timeout=30.0)
        rec = (listing.get("names") or {}).get(self.name)
        return (int(rec["latest"]) + 1) if rec else 1

    # ----------------------------------------------------------------- gc

    def _on_weights_msg(self, msg: Any) -> None:
        """Registry notices: drop refs of GC'd or reaped chunks so the
        refcount layer frees this process's store entries. Notices name
        explicit object ids: dropping by version alone would also free a
        new publish in flight under a reused number."""
        if not isinstance(msg, dict) or msg.get("name") != self.name:
            return
        if msg.get("kind") not in ("gc", "reaped"):
            return
        with self._lock:
            if "object_ids" in msg:
                # an EMPTY list is meaningful: every chunk of the dropped
                # version is still referenced by a kept delta manifest
                ids = set(msg["object_ids"] or ())
                for v in list(self._refs):
                    held = self._refs[v]
                    held[:] = [r for r in held if r.id not in ids]
                    if not held:
                        del self._refs[v]
            else:
                for v in msg.get("versions") or ():
                    self._refs.pop(int(v), None)

    def held_versions(self) -> List[int]:
        with self._lock:
            return sorted(self._refs)

    def held_object_ids(self) -> List[str]:
        """The object ids of every chunk this publisher keeps alive."""
        with self._lock:
            return [r.id for held in self._refs.values() for r in held]

    def close(self) -> None:
        """Drop every held version's chunks and the pubsub callback."""
        try:
            self._worker.unsubscribe_channel("weights",
                                             self._on_weights_msg)
        except Exception:  # noqa: BLE001 — worker already torn down
            pass
        with self._lock:
            self._refs.clear()


# Module-level publishers, one per name: refs must outlive publish() (they
# ARE the chunks' lifetime), so `publish(...)` keeps its publisher alive.
_publishers: Dict[str, WeightPublisher] = {}
_publishers_lock = threading.Lock()


def publisher(name: str = "default") -> WeightPublisher:
    """This process's cached publisher of `name` (replaced when the
    cluster it was made for is gone)."""
    cur = _worker()
    with _publishers_lock:
        pub = _publishers.get(name)
        if pub is None or pub._worker is not cur:
            pub = _publishers[name] = WeightPublisher(name)
    return pub


def publish(tree: Any, *, name: str = "default",
            step: Optional[int] = None, version: Optional[int] = None,
            run_id: str = "", delta: bool = False) -> int:
    """Publish from the per-name cached :class:`WeightPublisher`
    (`train.report(..., publish_weights=...)` lands here); the caching
    gives consecutive delta publishes a base to diff against."""
    return publisher(name).publish(tree, step=step, version=version,
                                   run_id=run_id, delta=delta)


def _reset_publishers() -> None:
    """Drop the cached publishers (and their chunks)."""
    with _publishers_lock:
        for pub in _publishers.values():
            pub.close()
        _publishers.clear()
