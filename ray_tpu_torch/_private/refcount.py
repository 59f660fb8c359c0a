"""Distributed reference counting — automatic object lifetime.

The ownership-model analog of the reference's ReferenceCounter
(src/ray/core_worker/reference_count.h:61): the process
that created an object (its OWNER) decides when it can be freed, using

  live = local_handles > 0        (ObjectRef instances in the owner)
       or wire > 0                (sender-held pins while a ref rides
                                   inside a task/actor call, released by
                                   the SAME sender at reply time)
       or borrowers != {}         (remote processes holding handles)
       or result still pending    (producing task hasn't finished)

Every process instance-counts its ObjectRef handles (`__init__`/`__del__`
hooks). Non-owner processes register themselves as borrowers with the
owner on their first handle for an id and deregister on the last drop.

Wire pins are SENDER-balanced: the submitter increfs when a ref rides
into call args and decrefs when the call's reply arrives (by which time
the receiver has unpickled its handles and enqueued its borrower
registration). Incref and decref travel on the same ordered channel from
the same process, so the pin accounting can never go out of balance —
unlike receiver-balanced schemes, where an adopt can outrun the matching
incref and a clamped decrement silently strands the count. The remaining
cross-channel race (sender's decref+drop arriving just before the
receiver's adopt, both flushed on independent ~100ms timers) is closed
by a grace period: owner-side frees are scheduled and re-verified
_FREE_GRACE_S later rather than executed instantly.

All messages are batched and sent asynchronously off a flusher thread:
`__del__` never blocks on an RPC.

On owner-zero the owner deletes its store entry (including any spill
file), forgets lineage, and pushes `free_objects` to the recorded holder
(large results executed elsewhere) and any lingering borrower caches.

Known limits (deliberate, documented): refs serialized out-of-band (into
the conductor KV, files, …) are invisible to the tracker — like the
reference, such refs need the user to keep a live handle. Refs hidden
inside opaque user objects in call args miss the wire pin (collect_refs
walks plain containers only) but still get borrower accounting when the
receiver unpickles them. A sender dying before its reply leaks its pin —
the object stays alive, never freed prematurely.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Set, Tuple

_FLUSH_PERIOD_S = 0.1
_FREE_GRACE_S = 0.3


class ReferenceTracker:
    """Per-process refcount state; one instance, attached to the Worker."""

    def __init__(self):
        # RLock: ObjectRef.__del__ can run inside ANY allocation (cyclic
        # GC), including one under this lock — a plain Lock would
        # self-deadlock on the nested untrack()
        self._lock = threading.RLock()
        # every process: live ObjectRef instances per id
        self._handles: Dict[str, int] = defaultdict(int)
        self._owner_of: Dict[str, Optional[Tuple[str, int]]] = {}
        # owner-side accounting for ids we own
        self._wire: Dict[str, int] = defaultdict(int)
        self._borrowers: Dict[str, Set[Tuple[str, int]]] = defaultdict(set)
        # ids freed while their producing task was still pending
        self._dead_pending: Set[str] = set()
        # owner-side: frees awaiting their grace re-check, oid -> due time
        self._free_due: Dict[str, float] = {}
        # outbox: owner addr -> list of (kind, object_id)
        self._outbox: Dict[Tuple[str, int], List[Tuple[str, str]]] = \
            defaultdict(list)
        self._worker = None  # set by attach()
        self._alive = True
        self._flusher: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def attach(self, worker) -> None:
        with self._lock:
            self._worker = worker
        if self._flusher is None:
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True, name="refcount-flush")
            self._flusher.start()

    def detach(self) -> None:
        """Called at worker shutdown: stop emitting RPCs, keep counting
        no-ops so late __del__s are harmless."""
        with self._lock:
            self._worker = None
            self._outbox.clear()
            self._free_due.clear()

    def _my_addr(self) -> Optional[Tuple[str, int]]:
        w = self._worker
        return tuple(w.address) if w is not None else None

    # ----------------------------------------------------- handle tracking

    def track(self, object_id: str, owner: Optional[Tuple[str, int]]) -> None:
        """An ObjectRef instance materialized in this process; the first
        foreign-owned one registers us as a borrower."""
        if not self._alive:
            return
        with self._lock:
            n = self._handles[object_id] = self._handles[object_id] + 1
            if owner is not None:
                self._owner_of.setdefault(object_id, tuple(owner))
            if n == 1:
                owner_addr = self._owner_of.get(object_id)
                me = self._my_addr()
                if owner_addr is not None and me is not None \
                        and tuple(owner_addr) != me:
                    self._outbox[tuple(owner_addr)].append(
                        ("adopt", object_id))

    def untrack(self, object_id: str) -> None:
        """An ObjectRef instance was garbage-collected."""
        if not self._alive:
            return
        free_oid = drop_cache = None
        with self._lock:
            n = self._handles.get(object_id)
            if n is None:
                return
            n -= 1
            if n > 0:
                self._handles[object_id] = n
                return
            del self._handles[object_id]
            owner_addr = self._owner_of.pop(object_id, None)
            me = self._my_addr()
            if me is None:
                return
            if owner_addr is not None and tuple(owner_addr) != me:
                # last local handle on a borrowed ref: tell the owner and
                # release our CACHE copy (see below, outside the lock)
                self._outbox[tuple(owner_addr)].append(("drop", object_id))
                drop_cache = object_id
            else:
                free_oid = object_id
        # Store calls happen OUTSIDE the tracker lock: a thread inside a
        # store method (holding its cv) can hit cyclic GC running
        # ObjectRef.__del__ → untrack (tracker lock) — taking the cv here
        # while holding the tracker lock would be the ABBA half of that
        # deadlock. delete_cached (not delete): if this process EXECUTED
        # the producing task, its entry is the authoritative holder copy
        # the owner's locator points at, not a refetchable cache.
        if drop_cache is not None:
            w = self._worker
            if w is not None:
                try:
                    w.store.delete_cached(drop_cache)
                except Exception:  # noqa: BLE001 — GC must not raise
                    pass
        if free_oid is not None:
            self._maybe_free_owned(free_oid)

    # --------------------------------------------------- submitter-side

    def wire_incref(self, refs) -> None:
        """Refs are about to ride into task/actor call args: pin them at
        their owners until wire_decref at reply time."""
        if not refs or not self._alive:
            return
        me = self._my_addr()
        with self._lock:
            for r in refs:
                owner = r.owner and tuple(r.owner)
                if owner is None or owner == me:
                    self._wire[r.id] += 1  # we own it: local fast path
                else:
                    self._outbox[owner].append(("incref", r.id))

    def wire_decref(self, refs) -> None:
        """The call carrying these refs completed (reply arrived): the
        receiver has adopted its handles, release the in-flight pins."""
        if not refs or not self._alive:
            return
        me = self._my_addr()
        to_check = []
        with self._lock:
            for r in refs:
                owner = r.owner and tuple(r.owner)
                if owner is None or owner == me:
                    if self._wire.get(r.id, 0) > 0:
                        self._wire[r.id] -= 1
                    to_check.append(r.id)
                else:
                    self._outbox[owner].append(("decref", r.id))
        for oid in to_check:
            self._maybe_free_owned(oid)

    # ------------------------------------------------------- owner-side RPC

    def apply_remote(self, from_addr, entries: List[Tuple[str, str]]) -> None:
        """Batched borrower/sender messages arriving at the owner."""
        from_addr = tuple(from_addr)
        to_check: Set[str] = set()
        with self._lock:
            for kind, oid in entries:
                if kind == "incref":
                    self._wire[oid] += 1
                elif kind == "decref":
                    if self._wire.get(oid, 0) > 0:
                        self._wire[oid] -= 1
                    to_check.add(oid)
                elif kind == "adopt":
                    self._borrowers[oid].add(from_addr)
                    # a registered borrower supersedes any scheduled free
                    self._free_due.pop(oid, None)
                elif kind == "drop":
                    self._borrowers[oid].discard(from_addr)
                    to_check.add(oid)
        for oid in to_check:
            self._maybe_free_owned(oid)

    def on_result_recorded(self, object_id: str) -> None:
        """Owner: a pending task result landed; free it if every handle
        died while it was still in flight."""
        self._maybe_free_owned(object_id)

    # ------------------------------------------------------------- freeing

    def _owned_live(self, object_id: str) -> bool:
        # caller must hold the lock
        return (self._handles.get(object_id, 0) > 0
                or self._wire.get(object_id, 0) > 0
                or bool(self._borrowers.get(object_id)))

    def _maybe_free_owned(self, object_id: str) -> None:
        """Schedule a grace-delayed free if the object looks dead; the
        flusher finalizes after _FREE_GRACE_S with a re-check (closes the
        sender-decref-vs-receiver-adopt cross-channel race)."""
        w = self._worker
        if w is None:
            return
        with self._lock:
            if self._owned_live(object_id):
                self._free_due.pop(object_id, None)
                return
            self._free_due.setdefault(object_id,
                                      time.monotonic() + _FREE_GRACE_S)

    def _finalize_due_frees(self) -> None:
        w = self._worker
        if w is None:
            return
        now = time.monotonic()
        with self._lock:
            due = [oid for oid, t in self._free_due.items() if t <= now]
            for oid in due:
                del self._free_due[oid]
        for oid in due:
            with self._lock:
                if self._owned_live(oid):
                    continue
                self._wire.pop(oid, None)
                borrowers = self._borrowers.pop(oid, set())
            if w._is_pending_local(oid):
                # producing task still running: free when the result lands
                with self._lock:
                    self._dead_pending.add(oid)
                # re-check: if the result landed between the pending check
                # and the mark, _record_results consulted was_freed_pending
                # BEFORE we set it — nobody else will finish this free
                if not w._is_pending_local(oid):
                    with self._lock:
                        self._dead_pending.discard(oid)
                    self._free_now(w, oid, borrowers)
                continue
            with self._lock:
                self._dead_pending.discard(oid)
            self._free_now(w, oid, borrowers)

    def was_freed_pending(self, object_id: str) -> bool:
        with self._lock:
            return object_id in self._dead_pending

    def _free_now(self, w, object_id: str, borrowers) -> None:
        try:
            w.store.delete(object_id)  # also unlinks any spill file
        except Exception:  # noqa: BLE001
            pass
        with w._state_lock:
            holder = w._locators.pop(object_id, None)
            w._lineage.pop(object_id, None)
        targets = set(borrowers)
        if holder is not None:
            targets.add(tuple(holder))
        for addr in targets:
            try:
                w.clients.get(tuple(addr)).notify("free_objects", [object_id])
            except Exception:  # noqa: BLE001 — holder already gone
                pass

    # -------------------------------------------------------------- flusher

    def _flush_loop(self) -> None:
        while self._alive:
            time.sleep(_FLUSH_PERIOD_S)
            self.flush()

    def flush(self) -> None:
        """Send the outbox and finalize due frees (also called directly
        by tests to accelerate convergence)."""
        with self._lock:
            w = self._worker
            if w is None:
                return
            batches, self._outbox = dict(self._outbox), defaultdict(list)
            me = self._my_addr()
        for addr, entries in batches.items():
            try:
                w.clients.get(tuple(addr)).notify(
                    "refcount_update", me, entries)
            except Exception:  # noqa: BLE001 — owner gone: nothing to free
                pass
        self._finalize_due_frees()

    # ------------------------------------------------------------ debugging

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tracked_handles": len(self._handles),
                "owned_with_wire": sum(1 for v in self._wire.values() if v),
                "owned_with_borrowers": sum(
                    1 for v in self._borrowers.values() if v),
                "dead_pending": len(self._dead_pending),
                "frees_scheduled": len(self._free_due),
            }


def collect_refs(args: tuple, kwargs: dict, max_items: int = 10_000,
                 max_depth: int = 8) -> list:
    """Every ObjectRef reachable through plain containers (list/tuple/
    dict/set) in task arguments — the wire-pin scan. Refs hidden inside
    opaque user objects are not seen here; they still get borrower
    accounting when the receiver unpickles them, just without the
    in-flight pin (reference_count.h covers those via serialization
    hooks; our tradeoff is documented in the module docstring)."""
    from .object_store import ObjectRef

    # iterative on purpose: a self-recursive closure is a reference CYCLE
    # (fn -> cell -> fn) that pins every scanned ObjectRef until a cyclic
    # GC pass — which silently delays borrow drops in idle workers
    out: list = []
    stack: list = [(args, 0), (kwargs, 0)]
    budget = max_items  # counts CONTAINERS, not leaves: a long list of
    #                     scalars must not exhaust the budget before a
    #                     trailing ObjectRef is reached (premature free)
    while stack:
        obj, depth = stack.pop()
        if isinstance(obj, ObjectRef):
            out.append(obj)
        elif depth < max_depth and budget > 0:
            if isinstance(obj, (list, tuple, set, frozenset)):
                budget -= 1
                stack.extend((item, depth + 1) for item in obj)
            elif isinstance(obj, dict):
                budget -= 1
                for k, v in obj.items():
                    stack.append((k, depth + 1))
                    stack.append((v, depth + 1))
    return out


tracker = ReferenceTracker()


def _interpreter_teardown_guard() -> None:
    tracker._alive = False


# During interpreter shutdown __del__ ordering is arbitrary; turn the
# tracker off before modules are torn down so late drops are no-ops.
import atexit  # noqa: E402

atexit.register(_interpreter_teardown_guard)
