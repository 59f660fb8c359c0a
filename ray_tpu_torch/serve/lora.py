"""Multi-tenant LoRA serving: a paged adapter pool over one resident base
model (port of ray_tpu/serve/lora.py).

- **AdapterPool**: adapters page through a refcounted LRU pool as KV
  blocks page through `models/kvcache.py`. Device stacks ``A [P, L, in,
  r_max]`` / ``B [P, L, r_max, out]`` per LoRA-target leaf
  (`models.generate.lora_targets`) and ``scale [P]``, one pool row per
  adapter, row 0 the null adapter (zero A and B, scale 0: the base
  model). ``acquire(tenant)`` pins a resident adapter (hit) or pages it
  in (miss: fetch, zero-pad the rank to ``rank_max``, write its row),
  evicting the least recently used unpinned row when the pool is full;
  pinned rows are never evicted. Acquisition runs on the submitting
  thread, so a cold tenant's fetch never stalls another tenant's decode
  tick.
- **Row writes** are in-place ``copy_`` into the stacks, O(row), never a
  copy of the pool (the JAX package donates its stacks to the same
  end). Every write and every read of the stacks (the decode tick's
  enqueue through ``dispatch_tick``, the prefill merge's
  ``adapter_slice``) is made under the pool lock, and all of them go to
  one CUDA stream, so a page-in never interleaves with a tick's enqueue
  and stream order does the rest.
- **Cross-tenant batched decode**: the engine's tick hands the stacks and
  per-slot rows to the model's ``*_decode(lora=)``, which gathers each
  slot's A and B and adds ``scale * (h @ A) @ B`` at the target leaves. A
  slot on the null adapter adds an exact zero.
- **Sources**: `LocalAdapterSource` is a host dict of adapter trees;
  ``publish()`` bumps a tenant's version and marks it dirty, and its next
  acquire hot-swaps the row in place. `FabricAdapterSource` pages each
  tenant's adapter from the live weight fabric (``lora/<tenant>``,
  published with `publish_adapter`); the ``weights`` channel marks a
  tenant dirty the moment a new version commits. ``build_pool(lora=
  True)`` builds a pool over it.

The JAX package's knobs ``RAY_TPU_LORA_POOL_SLOTS`` and
``RAY_TPU_LORA_RANK_MAX`` are the ``slots=8`` and ``rank_max=8``
arguments here. Not ported yet: the Prometheus metrics and conductor
push; ``stats()`` and ``drain_events()`` carry the same numbers.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.generate import lora_targets

_POOL_SEQ = itertools.count()
_EVENTS_KEPT = 512


def tenant_weights_name(tenant: str, prefix: str = "lora/") -> str:
    """The name a tenant's adapter is published under."""
    return f"{prefix}{tenant}"


# ------------------------------------------------------- host adapters

def make_lora_adapter(config: Any, rank: int, *, seed: int = 0,
                      scale: float = 1.0) -> Dict[str, Any]:
    """A host adapter tree for `config`'s LoRA-target leaves, ``{"scale":
    f32, "targets": {name: {"a": [L, in, r], "b": [L, r, out]}}}`` of
    numpy fp32, the JAX package's from the same seed. A and B are both
    random (B = 0, the classic init, would make every isolation check
    vacuous)."""
    rng = np.random.default_rng(seed)
    layers = len_blocks(config)
    targets: Dict[str, Any] = {}
    for name, d_in, d_out in lora_targets(config):
        targets[name] = {
            "a": (rng.standard_normal((layers, d_in, rank))
                  * 0.05).astype(np.float32),
            "b": (rng.standard_normal((layers, rank, d_out))
                  * 0.05).astype(np.float32),
        }
    return {"scale": np.float32(scale), "targets": targets}


def len_blocks(config: Any) -> int:
    return int(config.num_layers)


def adapter_nbytes(adapter: Dict[str, Any]) -> int:
    """Host bytes of one adapter tree."""
    return sum(int(np.asarray(ab[x]).nbytes)
               for ab in adapter["targets"].values() for x in ("a", "b"))


def adapter_rank(adapter: Dict[str, Any]) -> int:
    ab = next(iter(adapter["targets"].values()))
    return int(np.asarray(ab["a"]).shape[-1])


def publish_adapter(tenant: str, adapter: Dict[str, Any], *,
                    prefix: str = "lora/", delta: bool = True) -> int:
    """Publish a tenant's adapter to the weight fabric under
    ``lora/<tenant>`` (delta publication by default: a refresh usually
    touches a subset of leaves). Every subscribed pool sees the notice,
    marks the tenant dirty and hot-swaps on its next acquire. Returns
    the committed version."""
    from ..weights import publish

    return int(publish(adapter, name=tenant_weights_name(tenant, prefix),
                       delta=delta))


# ------------------------------------------------------ adapter sources

class LocalAdapterSource:
    """A paging source over a host dict of adapter trees. ``publish()``
    bumps the tenant's version and marks it dirty; `fetch_delay_s` makes
    each fetch slow, as a remote one would be."""

    def __init__(self, adapters: Optional[Dict[str, Any]] = None, *,
                 fetch_delay_s: float = 0.0):
        self._lock = threading.Lock()
        self._adapters: Dict[str, Tuple[int, Dict[str, Any]]] = {
            t: (1, a) for t, a in (adapters or {}).items()}
        self._dirty: set = set()
        self.fetch_delay_s = float(fetch_delay_s)

    def publish(self, tenant: str, adapter: Dict[str, Any]) -> int:
        with self._lock:
            ver = self._adapters.get(tenant, (0, None))[0] + 1
            self._adapters[tenant] = (ver, adapter)
            self._dirty.add(tenant)
        return ver

    def fetch(self, tenant: str) -> Tuple[int, Dict[str, Any], int]:
        if self.fetch_delay_s > 0:
            time.sleep(self.fetch_delay_s)
        with self._lock:
            entry = self._adapters.get(tenant)
            if entry is None:
                raise KeyError(f"no adapter registered for tenant "
                               f"{tenant!r}")
            self._dirty.discard(tenant)
            ver, adapter = entry
        return ver, adapter, adapter_nbytes(adapter)

    def dirty(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._dirty


def _worker():
    from .._private import worker as worker_mod

    return worker_mod.global_worker


class FabricAdapterSource:
    """Weight-fabric paging source: each tenant's adapter lives under
    ``lora/<tenant>`` in the versioned registry (delta publications, so a
    refresh ships only what changed). One `WeightSubscriber` per tenant,
    made at the tenant's first fetch; the shared ``weights`` channel
    marks a tenant dirty the moment a new version commits, so the next
    acquire hot-swaps without polling. A fetch returns the producer's
    tree with numpy leaves."""

    def __init__(self, prefix: str = "lora/"):
        self.prefix = str(prefix)
        self._lock = threading.Lock()
        self._subs: Dict[str, Any] = {}
        self._dirty: set = set()
        w = _worker()
        if w is None:
            raise RuntimeError(
                "FabricAdapterSource needs a live cluster "
                "(ray_tpu_torch.init()); use LocalAdapterSource without "
                "one")
        self._worker_ref = w
        w.subscribe_channel("weights", self._on_weights_msg)

    def _on_weights_msg(self, msg: Any) -> None:
        if not isinstance(msg, dict) or msg.get("kind") != "published":
            return
        name = str(msg.get("name") or "")
        if name.startswith(self.prefix):
            with self._lock:
                self._dirty.add(name[len(self.prefix):])

    def _sub(self, tenant: str):
        from ..weights import WeightSubscriber

        with self._lock:
            sub = self._subs.get(tenant)
        if sub is not None:
            return sub
        # made outside the lock (it talks to the conductor, and dirty()
        # runs on the pool's hot acquire path); a racing duplicate is
        # closed, the winner kept
        sub = WeightSubscriber(tenant_weights_name(tenant, self.prefix))
        with self._lock:
            cur = self._subs.get(tenant)
            if cur is None:
                self._subs[tenant] = sub
                return sub
        sub.close()
        return cur

    def fetch(self, tenant: str) -> Tuple[int, Dict[str, Any], int]:
        sub = self._sub(tenant)
        with self._lock:
            self._dirty.discard(tenant)
        adapter = sub.fetch()  # numpy leaves, the producer's tree
        stats = sub.last_stats
        ver = int(stats.version) if stats else 0
        moved = int(stats.fetched_bytes) if stats else 0
        return ver, adapter, moved

    def dirty(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._dirty

    def close(self) -> None:
        try:
            self._worker_ref.unsubscribe_channel("weights",
                                                 self._on_weights_msg)
        except Exception:  # noqa: BLE001 — worker already torn down
            pass
        with self._lock:
            subs, self._subs = dict(self._subs), {}
        for sub in subs.values():
            try:
                sub.close()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass


def build_pool(config: Any, lora: Any, *, slots: int = 8,
               rank_max: int = 8, device: Any = "cuda",
               prefix: str = "lora/") -> Optional["AdapterPool"]:
    """The `lora=` argument of a serving replica as a pool: None or False
    -> no pool; an AdapterPool -> itself (a shared pool); a dict of host
    adapter trees -> a pool over a `LocalAdapterSource`; any other object
    -> a pool over it as the source; True -> a pool paging from the
    weight fabric (`FabricAdapterSource`, which needs a live cluster)."""
    if lora is None or lora is False:
        return None
    if isinstance(lora, AdapterPool):
        return lora
    if lora is True:
        source: Any = FabricAdapterSource(prefix)
    elif isinstance(lora, dict):
        source = LocalAdapterSource(lora)
    else:
        source = lora
    return AdapterPool(config, slots=slots, rank_max=rank_max,
                       source=source, device=device)


class LoraPoolExhausted(RuntimeError):
    """Every pool row is pinned by an in-flight request: the caller sheds
    or retries."""


class _Resident:
    __slots__ = ("tenant", "row", "version", "rank", "ref", "last_used",
                 "nbytes")

    def __init__(self, tenant: str, row: int):
        self.tenant = tenant
        self.row = row
        self.version = 0
        self.rank = 0
        self.ref = 0
        self.last_used = 0
        self.nbytes = 0


class AdapterPool:
    """Refcounted LRU pool of LoRA adapters resident on `device` (CUDA
    unless the caller asks for the CPU) for one engine. Thread-safe;
    fetches run outside the lock, one at a time per tenant."""

    def __init__(self, config: Any, *, slots: int = 8, rank_max: int = 8,
                 source: Any = None, pool_id: Optional[str] = None,
                 device: Any = "cuda"):
        self.config = config
        self.slots = int(slots)
        self.rank_max = int(rank_max)
        if self.slots < 1 or self.rank_max < 1:
            raise ValueError("slots and rank_max must be >= 1")
        self.device = resolve_device(device)
        self.source = source if source is not None \
            else LocalAdapterSource()
        self.pool_id = pool_id or f"lorapool-{os.getpid()}-" \
                                  f"{next(_POOL_SEQ)}"
        self.targets = lora_targets(config)
        self.dtype = config.dtype
        layers = len_blocks(config)
        rows = self.slots + 1  # row 0: the null adapter
        # zeros everywhere: every row starts as the null adapter
        self._a = {name: torch.zeros((rows, layers, d_in, self.rank_max),
                                     dtype=self.dtype, device=self.device)
                   for name, d_in, _ in self.targets}
        self._b = {name: torch.zeros((rows, layers, self.rank_max, d_out),
                                     dtype=self.dtype, device=self.device)
                   for name, _, d_out in self.targets}
        self._scale = torch.zeros(rows, dtype=torch.float32,
                                  device=self.device)
        self._lock = threading.Lock()
        self._by_tenant: Dict[str, _Resident] = {}
        self._free: List[int] = list(range(rows - 1, 0, -1))
        self._loading: Dict[str, threading.Event] = {}
        # the last version ever installed per tenant, kept through
        # eviction: a tenant evicted, republished and paged in again
        # arrives at another version than its cached KV was computed
        # under, and the swap listeners must fire on that path too
        self._seen_versions: Dict[str, int] = {}
        self._tick = itertools.count(1)
        self._swap_listeners: List[Callable[[str, int], None]] = []
        self._events: List[Dict[str, Any]] = []
        self._stats: Dict[str, int] = {k: 0 for k in (
            "acquires", "hits", "misses", "evictions", "swaps",
            "page_in_bytes", "releases")}
        self._tenant_stats: Dict[str, Dict[str, int]] = {}

    # ----------------------------------------------------------- helpers

    def add_swap_listener(self, fn: Callable[[str, int], None]) -> None:
        """`fn(tenant, old_version)` runs (outside the pool lock) when a
        tenant moves to a new adapter version: a resident hot swap, or an
        eviction, a republish and a page-in. The engine drops the old
        version's KV namespace there; correctness does not depend on it,
        since a stale namespace is never looked up again."""
        self._swap_listeners.append(fn)

    @staticmethod
    def cache_namespace(tenant: str, version: Optional[int]) -> str:
        """The prefix-cache namespace of one (tenant, adapter version): a
        prefill that read version 1 commits under ``t@v1`` even if the row
        is swapped to version 2 meanwhile, and later lookups read
        ``t@v2``, so old-version KV is never served under a newer
        adapter."""
        return f"{tenant}@v{0 if version is None else int(version)}"

    def _tenant_locked(self, tenant: str) -> Dict[str, int]:
        ts = self._tenant_stats.get(tenant)
        if ts is None:
            ts = {k: 0 for k in ("hits", "misses", "evictions", "swaps")}
            self._tenant_stats[tenant] = ts
        return ts

    def _event_locked(self, ev: Dict[str, Any]) -> None:
        ev.setdefault("ts", time.time())
        ev.setdefault("pool", self.pool_id)
        self._events.append(ev)
        if len(self._events) > _EVENTS_KEPT:
            del self._events[:len(self._events) - _EVENTS_KEPT]

    def _pad(self, arr: np.ndarray, rank_axis: int) -> np.ndarray:
        """Zero-pad an adapter leaf's rank to ``rank_max``: the padded
        columns of A (rows of B) add exact zeros, so a rank-r adapter
        computes the delta it would at its own rank."""
        r = arr.shape[rank_axis]
        if r > self.rank_max:
            raise ValueError(f"adapter rank {r} exceeds the pool's rank_max "
                             f"{self.rank_max}")
        if r == self.rank_max:
            return arr
        pad = [(0, 0)] * arr.ndim
        pad[rank_axis] = (0, self.rank_max - r)
        return np.pad(arr, pad)

    def _write_row_locked(self, row: int, adapter: Dict[str, Any]) -> None:
        """Write one adapter into pool row `row` in place (``copy_`` per
        leaf, rounded to the pool's dtype). The caller holds the pool
        lock, under which every read of the stacks is enqueued too."""
        layers = len_blocks(self.config)
        leaves = []
        for name, d_in, d_out in self.targets:
            if name not in adapter["targets"]:
                raise ValueError(f"adapter has no leaf {name!r} for this "
                                 f"model's targets")
            a = self._pad(np.asarray(adapter["targets"][name]["a"]), 2)
            b = self._pad(np.asarray(adapter["targets"][name]["b"]), 1)
            if a.shape != (layers, d_in, self.rank_max) \
                    or b.shape != (layers, self.rank_max, d_out):
                raise ValueError(
                    f"adapter leaf {name!r} shaped a={a.shape} b={b.shape} "
                    f"does not fit this model's target ({layers}, "
                    f"{d_in}->{d_out})")
            leaves.append((name, a, b))
        # every leaf checked before the row is touched; inference mode, as
        # stacks made under it (an engine built there) take in-place
        # writes only under it, from whichever thread pages in
        with torch.inference_mode():
            for name, a, b in leaves:
                self._a[name][row].copy_(torch.from_numpy(
                    np.ascontiguousarray(a, np.float32)))
                self._b[name][row].copy_(torch.from_numpy(
                    np.ascontiguousarray(b, np.float32)))
            # ravel()[0]: a scale may come as a 0-d or a [1] array
            self._scale[row] = float(np.asarray(adapter.get("scale", 1.0),
                                                np.float32).ravel()[0])

    # ------------------------------------------------------------ paging

    def acquire(self, tenant: str) -> int:
        """Pin `tenant`'s adapter and return its pool row. Hit: resident
        and current, one more pin. Miss: page in (fetch outside the lock,
        one fetch at a time per tenant), evicting the LRU unpinned row
        when the pool is full. Dirty (a newer version was published):
        fetch again and hot-swap the same row. Raises LoraPoolExhausted
        when every row is pinned."""
        tenant = str(tenant)
        while True:
            # the dirty probe runs outside the pool lock: a source may
            # take its own lock, and a slow one must not stall the tick
            dirty = self.source.dirty(tenant)
            with self._lock:
                r = self._by_tenant.get(tenant)
                if r is not None and not dirty:
                    r.ref += 1
                    r.last_used = next(self._tick)
                    self._stats["acquires"] += 1
                    self._stats["hits"] += 1
                    self._tenant_locked(tenant)["hits"] += 1
                    return r.row
                loading = self._loading.get(tenant)
                if loading is None:
                    self._loading[tenant] = threading.Event()
                    break
            # another thread is paging this tenant in: wait, look again
            loading.wait(timeout=120.0)
        try:
            version, adapter, moved = self.source.fetch(tenant)
            row, prev_version = self._install(tenant, version, adapter,
                                              moved)
        finally:
            with self._lock:
                ev = self._loading.pop(tenant, None)
            if ev is not None:
                ev.set()
        if prev_version is not None:
            try:
                self._fire_swap_listeners(tenant, prev_version)
            except BaseException:
                self.release(tenant)
                raise
        return row

    def _fire_swap_listeners(self, tenant: str, old_version: int) -> None:
        for fn in self._swap_listeners:
            fn(tenant, old_version)

    def _install(self, tenant: str, version: int, adapter: Dict[str, Any],
                 moved: int) -> Tuple[int, Optional[int]]:
        """Returns ``(row, superseded version)``: the tenant's previous
        version when this install moved it to a new one (a resident hot
        swap or a page-in after a republish), else None."""
        rank = adapter_rank(adapter)
        nbytes = adapter_nbytes(adapter)
        with self._lock:
            now = next(self._tick)
            r = self._by_tenant.get(tenant)
            swapped = r is not None
            prev = self._seen_versions.get(tenant)
            superseded = prev if prev is not None \
                and prev != int(version) else None
            if r is None:
                if self._free:
                    row = self._free.pop()
                else:
                    victim = min((c for c in self._by_tenant.values()
                                  if c.ref == 0),
                                 key=lambda c: c.last_used, default=None)
                    if victim is None:
                        raise LoraPoolExhausted(
                            f"adapter pool {self.pool_id}: all "
                            f"{self.slots} rows pinned by in-flight "
                            f"requests")
                    del self._by_tenant[victim.tenant]
                    row = victim.row
                    self._stats["evictions"] += 1
                    self._tenant_locked(victim.tenant)["evictions"] += 1
                    self._event_locked({"kind": "evict",
                                        "tenant": victim.tenant,
                                        "row": row})
                r = _Resident(tenant, row)
                self._by_tenant[tenant] = r
            try:
                self._write_row_locked(r.row, adapter)
            except BaseException:
                if not swapped:  # a refused page-in leaves no resident
                    del self._by_tenant[tenant]
                    self._free.append(r.row)
                raise
            r.version = int(version)
            r.rank = rank
            r.nbytes = nbytes
            r.last_used = now
            r.ref += 1
            self._seen_versions[tenant] = int(version)
            self._stats["acquires"] += 1
            if swapped:
                self._stats["swaps"] += 1
                self._tenant_locked(tenant)["swaps"] += 1
                self._event_locked({"kind": "swap", "tenant": tenant,
                                    "row": r.row, "version": version})
            else:
                self._stats["misses"] += 1
                self._tenant_locked(tenant)["misses"] += 1
                self._event_locked({"kind": "page_in", "tenant": tenant,
                                    "row": r.row, "version": version,
                                    "bytes": moved or nbytes,
                                    "superseded": superseded})
            self._stats["page_in_bytes"] += moved or nbytes
            return r.row, superseded

    def release(self, tenant: str) -> None:
        """Drop one pin. An unpinned adapter stays resident (that is the
        cache) until LRU eviction takes its row."""
        with self._lock:
            r = self._by_tenant.get(str(tenant))
            if r is not None and r.ref > 0:
                r.ref -= 1
            self._stats["releases"] += 1

    def refresh(self, tenant: str) -> bool:
        """Hot-swap `tenant`'s resident adapter to the newest published
        version now (a publish marks the tenant dirty and its next acquire
        does this). False when the tenant is not resident or already
        current. Pins keep counting: the row's content changes, between
        two ticks' enqueues, not its identity."""
        tenant = str(tenant)
        with self._lock:
            if tenant not in self._by_tenant:
                return False
        version, adapter, moved = self.source.fetch(tenant)
        with self._lock:
            r = self._by_tenant.get(tenant)
            if r is None or r.version == int(version):
                return False
            old_version = r.version
            self._write_row_locked(r.row, adapter)
            r.version = int(version)
            r.rank = adapter_rank(adapter)
            r.nbytes = adapter_nbytes(adapter)
            self._seen_versions[tenant] = int(version)
            self._stats["swaps"] += 1
            self._stats["page_in_bytes"] += moved or r.nbytes
            self._tenant_locked(tenant)["swaps"] += 1
            self._event_locked({"kind": "swap", "tenant": tenant,
                                "row": r.row, "version": version})
        self._fire_swap_listeners(tenant, old_version)
        return True

    # -------------------------------------------------------- device API

    def _tick_args_locked(self, slot_adapter: np.ndarray) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "idx": torch.as_tensor(np.asarray(slot_adapter, np.int64),
                                   device=self.device),
            "scale": self._scale,
        }
        for name, _, _ in self.targets:
            out[name] = (self._a[name], self._b[name])
        return out

    def dispatch_tick(self, fn: Callable[[Dict[str, Any]], Any],
                      slot_adapter: np.ndarray) -> Any:
        """Build the mixed-tenant tick's `lora` argument (the per-slot pool
        rows and the stacks, the ``*_decode(lora=)`` layout) and run
        ``fn(args)`` under the pool lock, so a row write never lands
        between the tick's reads of the stacks; a page-in's fetch still
        overlaps the tick."""
        with self._lock:
            return fn(self._tick_args_locked(slot_adapter))

    def tick_args(self, slot_adapter: np.ndarray) -> Dict[str, Any]:
        """The tick argument for inspection. It holds the live stacks: a
        row write after this returns changes what it reads, so the engine
        goes through ``dispatch_tick``."""
        with self._lock:
            return self._tick_args_locked(slot_adapter)

    def adapter_slice(self, row: int, with_version: bool = False):
        """One adapter's device tensors for the single-tenant prefill
        merge, copied under the lock (a later hot swap does not change
        them): ``{"scale", "targets": {name: {"a": [L, in, r_max], "b":
        [L, r_max, out]}}}``. With ``with_version`` also the row's
        resident version, read under the same lock (the pair the
        versioned cache namespace needs)."""
        with self._lock:
            sl = {"scale": self._scale[row].clone(),
                  "targets": {name: {"a": self._a[name][row].clone(),
                                     "b": self._b[name][row].clone()}
                              for name, _, _ in self.targets}}
            if not with_version:
                return sl
            version = next((r.version for r in self._by_tenant.values()
                            if r.row == row), None)
            return sl, version

    def resident_version(self, tenant: str) -> Optional[int]:
        with self._lock:
            r = self._by_tenant.get(str(tenant))
            return None if r is None else r.version

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
            residents = {t: {"row": r.row, "version": r.version,
                             "rank": r.rank, "ref": r.ref,
                             "nbytes": r.nbytes}
                         for t, r in self._by_tenant.items()}
            s.update(
                role="pool",
                pool_id=self.pool_id,
                slots=self.slots,
                rank_max=self.rank_max,
                resident=len(residents),
                pinned=sum(1 for r in self._by_tenant.values() if r.ref > 0),
                utilization=len(residents) / self.slots,
                residents=residents,
                tenants={t: dict(v) for t, v in self._tenant_stats.items()},
            )
        acq = s["acquires"]
        s["hit_rate"] = s["hits"] / acq if acq else 0.0
        return s

    def drain_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._events = self._events, []
        return out


__all__ = ["AdapterPool", "LocalAdapterSource", "LoraPoolExhausted",
           "adapter_nbytes", "adapter_rank", "build_pool", "len_blocks",
           "make_lora_adapter", "tenant_weights_name"]
