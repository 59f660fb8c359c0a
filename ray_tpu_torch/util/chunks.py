"""Chunked object-plane transfer (port of ray_tpu/util/chunks.py): one
implementation of the "host array -> owned chunk -> point-to-point
fetch" path that the weight fabric ships tensors through without a
gather.

A producer puts each host buffer of one tensor shard into ITS OWN
object store as a chunk and passes around only a metadata entry naming
it; a consumer rebuilds an ``ObjectRef`` from the entry and pulls the
bytes point-to-point from the owner (shared memory on the same host, the
worker's ranged fetch across hosts). The conductor only ever sees
metadata.

Where the port differs:
- A chunk may be a torch tensor: a CUDA tensor is copied to the host
  once, at put time, and a bf16 tensor travels as its uint16 bits with
  "bfloat16" as the entry's dtype (numpy has no bf16), as the port's
  checkpoints write it. `fetch_tree` rebuilds a tensor leaf as a CPU
  tensor of its dtype and a numpy leaf as numpy.
- The retry count is the constructor's ``retries`` (default 2, the
  default of the JAX package's RAY_TPU_CHUNK_FETCH_RETRIES) and the
  scripted fetch delay comes from ``chaos_plan=``: no environment
  variable is read.

Ownership: the returned ``ObjectRef``s ARE the chunks' lifetime. Callers
hold them until every consumer has fetched; dropping the last ref frees
the store entry.
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .._private.object_store import ObjectRef

BF16 = "bfloat16"
# the JAX package's RAY_TPU_CHUNK_FETCH_RETRIES default
FETCH_RETRIES = 2

# Per-caller fetch accounting across every fetcher in this process:
# caller label ("weights", ...) -> the counters each fetcher keeps.
_CALLER_KEYS = ("chunks_local", "chunks_fetched", "fetched_bytes",
                "shm_bytes", "rpc_bytes", "fetch_retries")
_caller_totals: Dict[str, Dict[str, int]] = {}
_caller_lock = threading.Lock()


def caller_totals(caller: Optional[str] = None) -> Dict[str, Any]:
    """Process-wide fetch accounting grouped by caller label: one
    caller's counter dict, or ``{caller: counters}`` for all of them."""
    with _caller_lock:
        if caller is not None:
            return dict(_caller_totals.get(
                caller, {k: 0 for k in _CALLER_KEYS}))
        return {c: dict(v) for c, v in _caller_totals.items()}


# Transient pull failures worth retrying: a timed-out range fetch or a
# connection hiccup to the owning worker. ObjectLostError (the chunk is
# gone with its process) re-raises at once.
_TRANSIENT = (ConnectionError, EOFError, OSError, TimeoutError)


def host_chunk(value: Any) -> Tuple[np.ndarray, str, bool]:
    """(C-contiguous array, dtype name, was a tensor) for one chunk: a
    torch tensor copied to the host (bf16 as its uint16 bits, named
    "bfloat16"), raw 2-byte records (`V2`, how the port's snapshots hold
    bf16) viewed as uint16 and named "bfloat16", anything else as a numpy
    array. ``np.ascontiguousarray`` would promote a 0-d array to 1-d, so
    0-d arrays pass through as they are."""
    is_tensor = False
    name = None
    if type(value).__module__.startswith("torch"):
        import torch

        if isinstance(value, torch.Tensor):
            is_tensor = True
            t = value.detach()
            if t.device.type != "cpu":
                t = t.to("cpu")
            if t.dtype == torch.bfloat16:
                value, name = t.view(torch.int16).numpy().view(np.uint16), \
                    BF16
            else:
                value = t.numpy()
    arr = np.asarray(value)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        arr, name = arr.view(np.uint16), BF16
    if arr.ndim and not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return arr, name or arr.dtype.name, is_tensor


def ensure_chunkable(host_arr: Any) -> np.ndarray:
    """`host_arr` as a C-contiguous ndarray ready for the store (see
    `host_chunk`)."""
    return host_chunk(host_arr)[0]


def local_machine_id() -> str:
    """This host's identity: two processes sharing it hand chunks over
    shared memory instead of RPC."""
    from .._private.worker import machine_id

    return machine_id()


def put_chunk(worker, host_arr: Any) -> Tuple[Any, Dict[str, Any]]:
    """Put one host array (or tensor) into `worker`'s own store. Returns
    ``(ref, entry)``: hold `ref` for the chunk's lifetime; `entry` is the
    metadata a consumer needs to fetch it point-to-point, with the
    array's shape and dtype ("bfloat16" for bf16 bits)."""
    arr, name, is_tensor = host_chunk(host_arr)
    ref = worker.put(arr)
    entry = {"object_id": ref.id,
             "locator": list(worker.address),
             "machine": local_machine_id(),
             "nbytes": int(arr.nbytes),
             "shape": list(arr.shape),
             "dtype": name}
    if is_tensor:
        entry["tensor"] = True
    return ref, entry


class ChunkFetcher:
    """Chunk puller with a per-instance cache: each needed chunk crosses
    the object plane at most once per fetcher, with local-vs-remote
    accounting (``chunks_local`` / ``chunks_fetched`` /
    ``fetched_bytes``), split into the same-host shm path
    (``shm_bytes``) and cross-host RPC (``rpc_bytes``) by the entry's
    producer machine id. Callable with a chunk entry dict; returns the
    chunk's numpy array (bf16 as uint16 bits)."""

    def __init__(self, worker, timeout: float = 60.0,
                 on_read: Optional[Callable[[int, bool, bool],
                                            None]] = None,
                 seed_cache: Optional[Dict[str, np.ndarray]] = None,
                 retries: int = FETCH_RETRIES,
                 caller: str = "unlabeled", chaos_plan: Any = None):
        from ..resilience.chaos import chunk_fetch_delay_s

        self._worker = worker
        self._timeout = timeout
        self.caller = str(caller)
        self._on_read = on_read
        self._machine = local_machine_id()
        # bounded retry with backoff on TRANSIENT pull failures
        self._retries = max(0, int(retries))
        self._delay_s = chunk_fetch_delay_s(chaos_plan)
        # seed_cache: chunks something else already pulled (prefetch):
        # their first use accounts as a LOCAL read
        self._cache: Dict[str, np.ndarray] = dict(seed_cache or {})
        self._seeded = set(self._cache)
        self.chunks_local = 0
        self.chunks_fetched = 0
        self.fetched_bytes = 0
        self.shm_bytes = 0
        self.rpc_bytes = 0
        self.fetch_retries = 0

    @property
    def cache(self) -> Dict[str, np.ndarray]:
        """The pulled chunks by object id."""
        return self._cache

    def stats(self) -> Dict[str, Any]:
        """One accounting snapshot: chunks served locally vs pulled, and
        the pulled bytes split same-host shm vs cross-host RPC."""
        return {"chunks_local": self.chunks_local,
                "chunks_fetched": self.chunks_fetched,
                "fetched_bytes": self.fetched_bytes,
                "shm_bytes": self.shm_bytes,
                "rpc_bytes": self.rpc_bytes,
                "fetch_retries": self.fetch_retries,
                "caller": self.caller}

    def _account_caller(self, **deltas: int) -> None:
        with _caller_lock:
            tot = _caller_totals.setdefault(
                self.caller, {k: 0 for k in _CALLER_KEYS})
            for k, v in deltas.items():
                tot[k] += v

    def _get_with_retries(self, ref: ObjectRef) -> np.ndarray:
        if self._delay_s > 0:
            time.sleep(self._delay_s)  # the plan's scripted stretch
        attempt = 0
        while True:
            try:
                return np.asarray(self._worker.get(
                    ref, timeout=self._timeout))
            except _TRANSIENT:
                if attempt >= self._retries:
                    raise
                attempt += 1
                self.fetch_retries += 1
                self._account_caller(fetch_retries=1)
                time.sleep(min(5.0, 0.1 * 2.0 ** (attempt - 1)))

    def __call__(self, entry: Dict[str, Any]) -> np.ndarray:
        oid = entry["object_id"]
        arr = self._cache.get(oid)
        if arr is not None:
            if oid in self._seeded:
                self._seeded.discard(oid)
                self.chunks_local += 1
                self._account_caller(chunks_local=1)
                if self._on_read is not None:
                    self._on_read(int(entry.get("nbytes", arr.nbytes)),
                                  True, True)
            return arr
        was_local = self._worker.store.contains(oid)
        ref = ObjectRef(oid, locator=tuple(entry["locator"]),
                        owner=tuple(entry["locator"]))
        t_pull = time.perf_counter()
        arr = self._get_with_retries(ref)
        # the request trace current on this thread (a KV adoption under
        # the router's kv_transfer phase) adds up each pull's wall time,
        # a chaos delay_chunk_fetch stretch included: that is what names
        # kv_transfer as the tail owner
        from ..observability.requests import annotate

        annotate(pull_ms=round((time.perf_counter() - t_pull) * 1e3, 3),
                 pulls=1)
        nbytes = int(entry.get("nbytes", arr.nbytes))
        same_host = entry.get("machine", self._machine) == self._machine
        if was_local:
            self.chunks_local += 1
            self._account_caller(chunks_local=1)
        else:
            self.chunks_fetched += 1
            self.fetched_bytes += nbytes
            if same_host:
                self.shm_bytes += nbytes
                self._account_caller(chunks_fetched=1,
                                     fetched_bytes=nbytes, shm_bytes=nbytes)
            else:
                self.rpc_bytes += nbytes
                self._account_caller(chunks_fetched=1,
                                     fetched_bytes=nbytes, rpc_bytes=nbytes)
        if self._on_read is not None:
            self._on_read(nbytes, was_local, same_host)
        self._cache[oid] = arr
        return arr


# ---------------------------------------------------------- tree payloads

def leaf_value(arr: np.ndarray, entry: Dict[str, Any]) -> Any:
    """A fetched chunk as its producer put it: a CPU tensor of its dtype
    for a tensor (bf16 from its bits), numpy otherwise (numpy has no
    bf16, so a bf16 chunk is always a tensor)."""
    if entry.get("dtype") == BF16 or entry.get("tensor"):
        from ..train.checkpoint import to_tensor

        return to_tensor(np.array(arr), entry["dtype"])
    return arr


def put_tree(worker, tree: Any) -> Tuple[List[Any], Dict[str, Any]]:
    """Chunk every leaf of a tree (the port's `tree.tree_flatten`, JAX's
    leaf order) into `worker`'s store. Returns ``(refs, descriptor)``:
    hold `refs` until consumers fetched; the descriptor (leaf entries and
    the pickled structure) is metadata only."""
    from ..tree import tree_flatten

    leaves, structure = tree_flatten(tree)
    refs: List[Any] = []
    entries: List[Dict[str, Any]] = []
    total = 0
    for leaf in leaves:
        ref, entry = put_chunk(worker, leaf)
        refs.append(ref)
        entries.append(entry)
        total += entry["nbytes"]
    descriptor = {"leaves": entries,
                  "treedef": pickle.dumps(structure, protocol=5),
                  "total_bytes": total}
    return refs, descriptor


def fetch_tree(worker, descriptor: Dict[str, Any],
               fetcher: Optional[ChunkFetcher] = None) -> Any:
    """Materialize a ``put_tree`` descriptor: pull each leaf chunk
    point-to-point from its owner and unflatten."""
    from ..tree import tree_unflatten

    if fetcher is None:
        fetcher = ChunkFetcher(worker)
    leaves = [leaf_value(fetcher(entry), entry)
              for entry in descriptor["leaves"]]
    structure = pickle.loads(descriptor["treedef"])
    return tree_unflatten(structure, leaves)


__all__ = ["ChunkFetcher", "FETCH_RETRIES", "caller_totals",
           "ensure_chunkable", "fetch_tree", "host_chunk",
           "local_machine_id", "put_chunk", "put_tree"]
