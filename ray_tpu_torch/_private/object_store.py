"""Ownership-based object store.

The port's copy of the JAX package's store: a replacement for the
reference's plasma store + memory store (src/ray/object_manager/plasma/,
src/ray/core_worker/store_provider/). Design differences, deliberate:

- No store daemon. The process that *creates* a value holds it (ownership, cf.
  reference reference_count.h:61); peers fetch from the holder via RPC. Large
  host objects are written to POSIX shared memory so same-host readers map them
  zero-copy — the role plasma plays — but the segment is owned by the creating
  worker, not a daemon. A CUDA tensor is stored as its host bytes
  (serialization.py) and rebuilt on the consumer's GPU.
- Values above the `shm_threshold` flag go to shared memory; below, they stay
  inline in the holder's heap and ride the RPC reply on fetch.
- Eviction: holder-side LRU cap (the `object_store_cap` flag); evicted or
  lost objects can be reconstructed from lineage by the owner.

Large values live in the process's C++ slab arena (_native/shm_store.cc),
one mapping per process that peers attach once; an object that does not
fit in it takes a segment of its own. With `native_store=0` every large
value takes its own segment. A failed arena build raises; the store never
falls back to segments on its own. Segment names carry the port's own
prefixes (`rtt_a_<pid>_` for arenas, `rtt_s_<pid>_` for single objects),
so the JAX package's sweep and this one never touch each other's.
"""
from __future__ import annotations

import os
import struct
import tempfile
import threading
import time
from dataclasses import dataclass, field
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Tuple

from . import serialization
from .ids import ObjectID

ARENA_PREFIX = "rtt_a_"
SEGMENT_PREFIX = "rtt_s_"


def cleanup_leaked_segments() -> int:
    """Unlink /dev/shm/rtt_a_<pid>_* and rtt_s_<pid>_* segments whose
    owning process is dead. SIGKILL'ed workers cannot unlink their own segments; left to
    accumulate they hold tmpfs RAM and measurably degrade the shm object
    plane (observed 20-30x on 100MB fetches at ~4GB of leakage). Called
    from cluster stop/start; returns the number removed."""
    import glob
    import re

    removed = 0
    for path in glob.glob("/dev/shm/rtt_[as]_*"):
        m = re.match(r"rtt_[as]_(\d+)_", os.path.basename(path))
        if not m:
            continue
        try:
            os.kill(int(m.group(1)), 0)
        except ProcessLookupError:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
        except (PermissionError, OSError):
            pass  # alive under another uid / odd pid — not ours to touch
    return removed


def shm_threshold() -> int:
    """Bytes above which host objects go to shared memory — resolved via
    the flag table at use time (ray_config_def.h analog)."""
    from .config import config

    return config.shm_threshold


_ALIGN = 8


class ObjectRef:
    """Handle to a (possibly not-yet-computed) remote value.

    `locator` is the RPC address of the process that holds (or will hold) the
    value; `owner` is the address of the submitting process, which keeps the
    task lineage for reconstruction.
    """

    __slots__ = ("id", "locator", "owner", "__weakref__")

    def __init__(self, id: ObjectID | str | None = None,
                 locator: Optional[Tuple[str, int]] = None,
                 owner: Optional[Tuple[str, int]] = None):
        if isinstance(id, ObjectID):
            self.id = id.hex()
        else:
            self.id = id if id is not None else ObjectID().hex()
        self.locator = tuple(locator) if locator else None
        self.owner = tuple(owner) if owner else None
        # distributed refcounting (reference reference_count.h:61): every
        # handle instance is counted; the last drop releases/deregisters
        from . import refcount

        refcount.tracker.track(self.id, self.owner)

    def __del__(self):
        try:
            from . import refcount

            refcount.tracker.untrack(self.id)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def hex(self) -> str:
        return self.id

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id[:12]}…)"

    def __reduce__(self):
        return (ObjectRef, (self.id, self.locator, self.owner))

    # await support (asyncio callers, `get_async`)
    def __await__(self):
        from . import worker as _w

        value = yield from _w.global_worker.get_async(self).__await__()
        return value

    def future(self):
        from . import worker as _w

        return _w.global_worker.get_future(self)


@dataclass
class _Entry:
    meta: Optional[bytes] = None
    buffers: Optional[List[memoryview]] = None
    shm_name: Optional[str] = None
    layout: Optional[List[Tuple[int, int]]] = None  # (offset, size) per buffer
    shm: Optional[shared_memory.SharedMemory] = None
    arena_offset: Optional[int] = None  # owner-side: block to free on delete
    nbytes: int = 0
    error: Optional[BaseException] = None
    ready: bool = False
    last_access: float = field(default_factory=time.monotonic)
    pinned: int = 0
    # on-disk copy written by eviction-spill; data is restored (or range-
    # read) from here on next access (reference local_object_manager.h:53)
    spill_path: Optional[str] = None
    # True for entries whose bytes THIS process authored (put_value):
    # possibly the only copy in the cluster (the owner's locator may point
    # here). False for fetched caches, which are refetchable.
    primary: bool = False

    @property
    def in_memory(self) -> bool:
        return (self.buffers is not None or self.shm_name is not None
                or self.error is not None)


class LocalObjectStore:
    """Per-process store: holds objects this process created, caches fetched
    ones, and provides blocking get with readiness signaling."""

    def __init__(self, cap: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self._entries: Dict[str, _Entry] = {}
        self._cv = threading.Condition()
        self._attached: Dict[str, Any] = {}  # SharedMemory or attached Arena
        self._bytes = 0
        from .config import config

        self._cap = int(cap) if cap is not None else config.object_store_cap
        # Eviction SPILLS owned objects here instead of dropping them, so
        # put() beyond the memory cap stays correct (reference
        # local_object_manager.h:53 spill + restore)
        self._spill_dir = spill_dir or os.path.join(
            config.spill_dir or os.path.join(tempfile.gettempdir(),
                                             "ray_tpu_torch_spill"),
            str(os.getpid()))
        # objects for which only a placeholder exists (awaiting task result)
        # Values already deserialized (or put) here, returned as they are
        # by the next get. A payload that holds a tensor is never cached:
        # tensors are written in place, and each get must return the
        # value as it was put.
        self._deserialized_cache: Dict[str, Any] = {}
        # Native C++ slab arena (shm_store.cc): one mapping for ALL of this
        # process's large objects — peers attach once and read at offsets
        # instead of one shm_open+mmap per object. None (native_store=0)
        # → per-object SharedMemory segments. A failed build raises.
        self._arena = None
        if config.native_store:
            from .._native import Arena

            self._arena = Arena.create(
                f"{ARENA_PREFIX}{os.getpid()}_{ObjectID().hex()[:8]}",
                config.arena_size)
        # Freed arena blocks rest here ~2s before reuse so a peer mid-copy
        # of an exported object never reads recycled bytes (the reference
        # uses plasma pins; deferred reuse is the ownership-model analog).
        self._arena_quarantine: List[Tuple[float, int]] = []

    # ---------- write paths ----------

    def put_value(self, object_id: str, value: Any) -> int:
        """Serialize and store; returns total bytes."""
        meta, buffers = serialization.serialize(value)
        total = sum(b.nbytes for b in buffers)
        e = _Entry(meta=meta, nbytes=len(meta) + total, primary=True)
        if total >= shm_threshold():
            size = 0
            layout = []
            for b in buffers:
                off = (size + _ALIGN - 1) // _ALIGN * _ALIGN
                layout.append((off, b.nbytes))
                size = off + b.nbytes
            base = self._arena.alloc(max(size, 1)) if self._arena else 0
            if base:
                mem = self._arena.view(base, size)
                e.arena_offset = base
                e.shm_name = f"arena:{self._arena.name}"
                e.layout = [(base + off, n) for off, n in layout]
            else:  # no native store, or arena full: per-object segment
                shm = shared_memory.SharedMemory(
                    name=f"{SEGMENT_PREFIX}{os.getpid()}_"
                         f"{ObjectID().hex()[:16]}",
                    create=True, size=max(size, 1))
                mem = shm.buf
                e.shm, e.shm_name, e.layout = shm, shm.name, layout
            for (off, n), b in zip(layout, buffers):
                mem[off:off + n] = \
                    b.cast("B")[:] if b.format != "B" else b[:]
        else:
            e.buffers = [memoryview(bytes(b)) for b in buffers]
        e.ready = True
        with self._cv:
            self._entries[object_id] = e
            self._bytes += e.nbytes
            if not serialization.holds_tensor(meta):
                self._deserialized_cache[object_id] = value
            self._cv.notify_all()
        self._maybe_evict()
        return e.nbytes

    def put_serialized(self, object_id: str, meta: bytes,
                       buffers: List[memoryview], copy: bool = True) -> None:
        """copy=False adopts the buffers as-is (chunked-fetch assembly
        already owns a private bytearray — don't double the peak)."""
        e = _Entry(meta=meta,
                   buffers=[memoryview(bytes(b)) for b in buffers] if copy
                   else [memoryview(b) for b in buffers],
                   nbytes=len(meta) + sum(b.nbytes for b in buffers), ready=True)
        with self._cv:
            self._entries[object_id] = e
            self._bytes += e.nbytes
            self._cv.notify_all()
        self._maybe_evict()

    def put_shm_reference(self, object_id: str, meta: bytes, shm_name: str,
                          layout: List[Tuple[int, int]]) -> None:
        """Record a fetched same-host shm object (zero-copy read path)."""
        e = _Entry(meta=meta, shm_name=shm_name, layout=layout,
                   nbytes=len(meta), ready=True)
        with self._cv:
            self._entries[object_id] = e
            self._bytes += e.nbytes
            self._cv.notify_all()

    def put_error(self, object_id: str, error: BaseException) -> None:
        e = _Entry(error=error, ready=True)
        with self._cv:
            self._entries[object_id] = e
            self._cv.notify_all()

    def invalidate(self, object_id: str) -> None:
        """Drop a (possibly pending) entry so waiters see it as missing."""
        with self._cv:
            e = self._entries.pop(object_id, None)
            self._deserialized_cache.pop(object_id, None)
            if e is not None:
                self._bytes -= e.nbytes
                self._free_entry(e)
            self._cv.notify_all()

    # ---------- read paths ----------

    def contains(self, object_id: str) -> bool:
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and e.ready

    def size_of(self, object_id: str) -> int:
        """Stored size in bytes, 0 if absent/not ready (locality hints)."""
        with self._cv:
            e = self._entries.get(object_id)
            return e.nbytes if e is not None and e.ready else 0

    def notify_waiters(self) -> None:
        """Wake wait_ready()/Worker._wait_result waiters so they re-check
        out-of-store readiness signals (e.g. a large result recorded as a
        remote locator — no store entry is ever created for those)."""
        with self._cv:
            self._cv.notify_all()

    def wait_change(self, timeout: float) -> None:
        """Bounded wait for ANY readiness change (local puts, errors, and
        remote object_available pushes routed through notify_waiters).
        A wake between the caller's check and this wait is missed — the
        bounded timeout makes that a latency blip, never a hang."""
        with self._cv:
            self._cv.wait(timeout)

    def wait_ready_once(self, object_id: str, timeout: float) -> bool:
        """One bounded cv wait: True iff an entry for `object_id` is ready.
        Returns early (False) on any notify_waiters() wake so callers can
        re-check out-of-store readiness (locators, vanished submitters)
        without this module knowing about owner-side state."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is not None and e.ready:
                return True
            self._cv.wait(timeout)
            e = self._entries.get(object_id)
            return e is not None and e.ready

    def wait_ready(self, object_id: str, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                e = self._entries.get(object_id)
                if e is not None and e.ready:
                    return True
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is None or remaining < 0.2 else 0.2)

    def get_local(self, object_id: str) -> Any:
        """Deserialize a ready local entry (raises stored errors)."""
        with self._cv:
            if object_id in self._deserialized_cache:
                return self._deserialized_cache[object_id]
            e = self._entries.get(object_id)
            if e is None or not e.ready:
                raise KeyError(object_id)
            e.last_access = time.monotonic()
            if e.error is not None:
                raise e.error
            self._ensure_resident_locked(e)
            e.pinned += 1  # a concurrent eviction must not spill mid-read
        try:
            if e.shm_name is not None:
                if e.shm_name.startswith("arena:"):
                    # Arena blocks are RECYCLED after free (unlike per-object
                    # segments, whose pages survive unlink), so any deserialize
                    # that could outlive the entry copies out of the mapping —
                    # the ownership-model stand-in for plasma pins. Owner reads
                    # of own puts are served by _deserialized_cache above,
                    # except for payloads that hold a tensor.
                    shm = (self._arena if e.arena_offset is not None
                           else self._attach(e.shm_name))
                    bufs = [memoryview(bytes(shm.buf[off:off + n]))
                            for off, n in e.layout]
                else:
                    shm = e.shm or self._attach(e.shm_name)
                    bufs = [memoryview(shm.buf)[off:off + n]
                            for off, n in e.layout]
            else:
                bufs = e.buffers or []
            try:
                value = serialization.deserialize(e.meta, bufs)
            except serialization.GpuLeaseRequiredError as err:
                raise serialization.GpuLeaseRequiredError(
                    f"object {object_id}: {err}") from None
        finally:
            with self._cv:
                e.pinned -= 1
        if not serialization.holds_tensor(e.meta):
            with self._cv:
                self._deserialized_cache[object_id] = value
        self._maybe_evict()  # a restore may have pushed us over the cap
        return value

    def export(self, object_id: str) -> Tuple[bytes, Optional[str],
                                              Optional[List[Tuple[int, int]]],
                                              Optional[List[bytes]]]:
        """For serving a fetch RPC: (meta, shm_name, layout, inline_buffers)."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.ready:
                raise KeyError(object_id)
            if e.error is not None:
                raise e.error
            e.last_access = time.monotonic()
            self._ensure_resident_locked(e)
            if e.shm_name is not None:
                return e.meta, e.shm_name, e.layout, None
            return e.meta, None, None, [bytes(b) for b in (e.buffers or [])]

    # ---------- lifetime ----------

    def pin(self, object_id: str) -> None:
        with self._cv:
            e = self._entries.get(object_id)
            if e is not None:
                e.pinned += 1

    def unpin(self, object_id: str) -> None:
        with self._cv:
            e = self._entries.get(object_id)
            if e is not None and e.pinned > 0:
                e.pinned -= 1

    def delete(self, object_id: str) -> None:
        with self._cv:
            e = self._entries.pop(object_id, None)
            self._deserialized_cache.pop(object_id, None)
        if e is not None:
            with self._cv:
                self._bytes -= e.nbytes
            self._free_entry(e)

    def delete_cached(self, object_id: str) -> None:
        """Delete only if the entry is a fetched CACHE copy. A primary
        entry (bytes authored here — possibly the cluster's only copy,
        pointed at by the owner's locator) survives; the owner's
        free_objects is the authoritative release for those."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or e.primary:
                return
            self._entries.pop(object_id, None)
            self._deserialized_cache.pop(object_id, None)
            self._bytes -= e.nbytes
        self._free_entry(e)

    _QUARANTINE_S = 2.0

    def _drain_quarantine(self, everything: bool = False) -> None:
        now = time.monotonic()
        with self._cv:
            if everything:
                ready = [o for _, o in self._arena_quarantine]
                self._arena_quarantine = []
            else:
                ready = [o for t, o in self._arena_quarantine if t <= now]
                self._arena_quarantine = [
                    (t, o) for t, o in self._arena_quarantine if t > now]
        if self._arena is not None:
            for off in ready:
                self._arena.free(off)

    def _free_entry(self, e: _Entry) -> None:
        if e.arena_offset is not None and self._arena is not None:
            with self._cv:
                self._arena_quarantine.append(
                    (time.monotonic() + self._QUARANTINE_S,
                     e.arena_offset))
            e.arena_offset = None
            self._drain_quarantine()
        if e.shm is not None:
            # unlink BEFORE close: close() raises BufferError when a
            # zero-copy deserialized array the user still holds references
            # the mapping — the name must be released regardless, and the
            # error must never abort the caller (eviction / delete paths);
            # the pages live until the last mapping drops.
            try:
                e.shm.unlink()
            except (FileNotFoundError, OSError):
                pass
            try:
                e.shm.close()
            except (OSError, BufferError):
                pass
        if e.spill_path is not None:
            try:
                os.unlink(e.spill_path)
            except OSError:
                pass
            e.spill_path = None

    def _attach(self, name: str):
        with self._cv:
            shm = self._attached.get(name)
            if shm is not None:
                return shm
        if name.startswith("arena:"):
            from .._native import Arena

            shm = Arena.attach(name[len("arena:"):])
            if shm is None:
                raise KeyError(f"arena {name} is gone")
        else:
            shm = shared_memory.SharedMemory(name=name)
        with self._cv:
            self._attached[name] = shm
        return shm

    # ---------- spill / restore (reference local_object_manager.h:53) ----

    _SPILL_HDR = struct.Struct(">I")     # len(meta)
    _SPILL_CNT = struct.Struct(">I")     # n buffers
    _SPILL_SZ = struct.Struct(">Q")      # per-buffer size

    def _gather_buffers_locked(self, e: _Entry) -> Optional[List[memoryview]]:
        """Current in-memory payload views, or None if not resident."""
        if e.buffers is not None:
            return e.buffers
        if e.shm_name is not None and e.layout is not None:
            if e.shm_name.startswith("arena:"):
                shm = (self._arena if e.arena_offset is not None
                       else self._attached.get(e.shm_name))
                if shm is None:
                    return None
            else:
                shm = e.shm or self._attached.get(e.shm_name)
                if shm is None:
                    return None
            return [memoryview(shm.buf)[off:off + n] for off, n in e.layout]
        return None

    def _spill_entry_locked(self, oid: str, e: _Entry) -> bool:
        """Write payload to disk, then drop the memory copy. Must hold
        lock (eviction is the cold path; the write is tolerable here).

        Only entries whose bytes WE own are spillable. A zero-copy
        reference into another process's arena (put_shm_reference) may
        already point at recycled memory by the time we evict — spilling
        it would persist garbage as the object's value. Those are dropped
        and refetched instead."""
        owned = (e.buffers is not None or e.shm is not None
                 or e.arena_offset is not None)
        if not owned:
            return False
        bufs = self._gather_buffers_locked(e)
        if bufs is None:
            return False
        if e.spill_path is None or not os.path.exists(e.spill_path):
            os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(self._spill_dir, oid)
            tmp = path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    f.write(self._SPILL_HDR.pack(len(e.meta or b"")))
                    f.write(e.meta or b"")
                    f.write(self._SPILL_CNT.pack(len(bufs)))
                    for b in bufs:
                        f.write(self._SPILL_SZ.pack(b.nbytes))
                    for b in bufs:
                        f.write(b.cast("B") if b.format != "B" else b)
                os.replace(tmp, path)
            except OSError:
                return False
            e.spill_path = path
        # free the memory copy (entry stays, ready, restorable)
        self._deserialized_cache.pop(oid, None)
        self._bytes -= e.nbytes
        if e.arena_offset is not None and self._arena is not None:
            self._arena_quarantine.append(
                (time.monotonic() + self._QUARANTINE_S, e.arena_offset))
            e.arena_offset = None
        if e.shm is not None:
            # unlink-then-close, tolerating BufferError — see _free_entry;
            # an exported buffer must never abort a spill under pressure
            try:
                e.shm.unlink()
            except (FileNotFoundError, OSError):
                pass
            try:
                e.shm.close()
            except (OSError, BufferError):
                pass
            e.shm = None
        e.buffers = None
        e.shm_name = None
        e.layout = None
        return True

    def _read_spill_header(self, f):
        """(meta, buffer_sizes, payload_file_offset) — cheap: no payload."""
        (meta_len,) = self._SPILL_HDR.unpack(f.read(self._SPILL_HDR.size))
        meta = f.read(meta_len)
        (n,) = self._SPILL_CNT.unpack(f.read(self._SPILL_CNT.size))
        sizes = [self._SPILL_SZ.unpack(f.read(self._SPILL_SZ.size))[0]
                 for _ in range(n)]
        return meta, sizes, f.tell()

    def _read_spill_file(self, path: str):
        with open(path, "rb") as f:
            meta, sizes, _ = self._read_spill_header(f)
            bufs = [memoryview(f.read(sz)) for sz in sizes]
        return meta, bufs

    def _read_spill_range(self, path: str, start: int, size: int) -> bytes:
        """Seek-and-read: a chunked fetch of a spilled multi-GB object
        must not load (or re-load) the whole file per chunk."""
        with open(path, "rb") as f:
            _, sizes, data_off = self._read_spill_header(f)
            total = sum(sizes)
            start = min(start, total)
            f.seek(data_off + start)
            return f.read(min(size, total - start))

    def _restore_locked(self, e: _Entry) -> None:
        """Load a spilled entry back into heap buffers. The spill file is
        kept: a later re-evict of an unmodified object is then free."""
        meta, bufs = self._read_spill_file(e.spill_path)
        e.meta = meta
        e.buffers = bufs
        e.layout = None
        self._bytes += e.nbytes

    def _ensure_resident_locked(self, e: _Entry) -> None:
        if not e.in_memory and e.spill_path is not None:
            self._restore_locked(e)

    # ---------- chunked streaming (reference pull_manager.cc 64MB) -------

    def stream_info(self, object_id: str):
        """(meta, total_payload_bytes, buffer_sizes) without forcing a
        spilled object back into memory — the remote-fetch header."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.ready:
                raise KeyError(object_id)
            if e.error is not None:
                raise e.error
            e.last_access = time.monotonic()
            if e.in_memory:
                bufs = self._gather_buffers_locked(e)
                if bufs is None:
                    raise KeyError(object_id)
                return e.meta, sum(b.nbytes for b in bufs), \
                    [b.nbytes for b in bufs]
            with open(e.spill_path, "rb") as f:
                meta, sizes, _ = self._read_spill_header(f)
            return meta, sum(sizes), sizes

    def read_range(self, object_id: str, start: int, size: int) -> bytes:
        """Bytes [start, start+size) of the object's payload stream (all
        buffers concatenated). Serves from memory or the spill file."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.ready:
                raise KeyError(object_id)
            if e.error is not None:
                raise e.error
            e.last_access = time.monotonic()
            bufs = self._gather_buffers_locked(e) if e.in_memory else None
            if bufs is None and e.spill_path is not None:
                return self._read_spill_range(e.spill_path, start, size)
            if bufs is None:
                raise KeyError(object_id)
            out = bytearray()
            pos = 0
            for b in bufs:
                if size <= 0:
                    break
                b = b.cast("B") if b.format != "B" else b
                if pos + b.nbytes > start:
                    lo = max(0, start - pos)
                    take = min(b.nbytes - lo, size)
                    out += b[lo:lo + take]
                    size -= take
                    start += take
                pos += b.nbytes
            return bytes(out)

    def _maybe_evict(self) -> None:
        self._drain_quarantine()
        with self._cv:
            if self._bytes <= self._cap:
                return
            entries = sorted(
                ((oid, e) for oid, e in self._entries.items()
                 if e.ready and e.pinned == 0 and e.error is None
                 and e.in_memory),
                key=lambda kv: kv[1].last_access)
            for oid, e in entries:
                if self._bytes <= self._cap * 0.8:
                    break
                if self._spill_entry_locked(oid, e):
                    continue
                # not ours to spill (zero-copy reference into another
                # process's memory): drop — it is refetchable
                self._entries.pop(oid, None)
                self._deserialized_cache.pop(oid, None)
                self._bytes -= e.nbytes
                self._free_entry(e)

    def stats(self) -> Dict[str, int]:
        with self._cv:
            spilled = [e for e in self._entries.values()
                       if not e.in_memory and e.spill_path is not None]
            return {"num_objects": len(self._entries), "bytes": self._bytes,
                    "spilled_objects": len(spilled),
                    "spilled_bytes": sum(e.nbytes for e in spilled)}

    def shutdown(self) -> None:
        with self._cv:
            entries = list(self._entries.values())
            self._entries.clear()
            self._deserialized_cache.clear()
            attached = list(self._attached.values())
            self._attached.clear()
        for e in entries:
            self._free_entry(e)
        for shm in attached:
            try:
                shm.close()
            except OSError:
                pass
        if self._arena is not None:
            # unlink the name only — munmap here would SIGSEGV any zero-copy
            # array the user still holds; the mapping dies with the process.
            self._arena.unlink_only()
            self._arena = None
