"""Activation/gradient channels: point-to-point microbatch transfer
between adjacent stage-gangs (port of ray_tpu/mpmd/channels.py).

A channel is unidirectional (one sender stage, one receiver stage) and
moves pytrees of host arrays through the object plane's shared chunked
transfer (``util.chunks`` — the weight fabric's 64MB-chunked no-gather
path, one implementation for both subsystems). Sends require an OPEN
pipeline registry entry (``pipeline_open``): a closed or GC-evicted
generation's sends fail fast instead of leaking undeliverable entries
toward the conductor's mailbox cap. The payload never rides
the control plane: ``send`` puts every leaf into the SENDER's own object
store and registers only a metadata descriptor in the conductor's
channel mailbox; ``recv`` takes the descriptor and pulls the chunks
directly from the sender's store (shm zero-copy on the same host,
64MB-ranged streaming across hosts/DCN). Same no-full-copy invariant as
the weights: no process other than sender and receiver ever holds the
bytes, and the conductor holds none at all.

Ownership: the sender's ObjectRefs ARE the chunks' lifetime. A slot
(mb, kind) is retained for the current and previous pipeline step —
schedule dependencies guarantee the receiver consumed a slot before the
sender can produce it twice more — so per-stage channel memory is
bounded at 2*M live microbatch tensors regardless of run length.

Wakeup rides the `pipeline` pubsub channel with a bounded poll as the
safety net (a conductor restart drops subscriptions), mirroring
WeightSubscriber.wait_for_version.

``prefetch(step, mb, kind)`` starts the pull in the background so the
next microbatch's chunks stream WHILE the stage computes the current
one (the ``WeightSync(prefetch=True)`` shape) — ``run_stage`` issues it
right after each recv, shrinking ``bubble_wait`` to the residual wait;
``stats.prefetch_hits`` counts recvs served this way and the
no-full-copy accounting is unchanged (the prefetch's fetcher is adopted
by the recv, so every chunk still crosses the plane exactly once).

What crosses a channel in the port: a tensor leaf on the card is copied
to the host once, at ``send`` (the chunk fabric's rule; a bf16 leaf
travels as its bits). A channel built with ``device=`` returns every
leaf of a ``recv`` as a tensor on that device, in its dtype; without
one, leaves come back as ``util.chunks.fetch_tree`` rebuilds them (CPU
tensors, numpy arrays). A channel never changes a value.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..util import chunks
from ..util.runtime import pipeline_run_token as run_token
from ..util.runtime import require_worker

from .metrics import pipeline_metrics


@dataclass
class ChannelStats:
    """Accounting for one endpoint (send and/or recv side)."""

    sent_msgs: int = 0
    sent_chunks: int = 0
    sent_bytes: int = 0
    recv_msgs: int = 0
    recv_chunks: int = 0
    recv_bytes: int = 0
    # chunks that crossed the object plane vs. served from the local
    # store (same-host stages) — the no-full-copy accounting: bytes
    # moved == payload bytes, exactly once per chunk
    fetched_remote_chunks: int = 0
    fetched_remote_bytes: int = 0
    max_fetch_bytes: int = 0
    wait_s: float = 0.0  # cumulative blocked-in-recv (bubble) time
    # recvs served by a prefetch issued during stage compute (the
    # WeightSync(prefetch=True) shape): their fetch overlapped compute,
    # so only the residual wait — not the whole transfer — is bubble
    prefetch_hits: int = 0
    per_kind: Dict[str, int] = field(default_factory=dict)


class ActivationChannel:
    """One directed edge of the pipeline graph: stage `src` -> `dst` of
    pipeline `name`. ``kind`` distinguishes payload streams sharing the
    edge ("act" forward activations, "grad" backward gradients travel
    the REVERSED edge via their own channel instance)."""

    def __init__(self, name: str, src: int, dst: int, *,
                 stage: Optional[int] = None,
                 run_id: str = "",
                 poll_interval: float = 0.25,
                 device: Any = None,
                 worker=None):
        self.name = name
        # where recv() puts the payload (None: as fetched)
        self.device = device
        self.src = int(src)
        self.dst = int(dst)
        # which stage this endpoint belongs to (metrics tag); defaults
        # to the sender for send-side use
        self.stage = self.src if stage is None else int(stage)
        # run_id scopes the keys to ONE pipeline generation: after a
        # driver restart reopens the name, an orphaned old stage's
        # sends can never be delivered to the new generation's recvs
        # (their keys differ), on top of pipeline_open's mailbox purge.
        # "/" is the key separator, so the run token flattens it
        # (run_token() — the conductor's put fencing parses it back).
        self._prefix = (f"{name}/ch/{run_token(run_id)}/"
                        f"{self.src}->{self.dst}")
        self._worker = worker or require_worker(
            "using pipeline channels")
        self._poll = max(0.001, float(poll_interval))
        self.stats = ChannelStats()
        # (step, mb, kind) -> chunk refs; holding them IS the chunks'
        # lifetime (see module docstring for the retention window)
        self._held: Dict[Tuple[int, int, str], List[Any]] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition()
        # (step, mb, kind) -> in-flight prefetch record; recv() drains
        # it instead of polling the mailbox itself
        self._prefetched: Dict[Tuple[int, int, str],
                               Dict[str, Any]] = {}
        self._closed = False
        self._worker.subscribe_channel("pipeline", self._on_msg)

    # ------------------------------------------------------------- pubsub

    def _on_msg(self, msg: Any) -> None:
        """Pure wakeup: the mailbox take below stays the source of
        truth for what is actually deliverable."""
        if isinstance(msg, dict) and msg.get("kind") == "channel_put" \
                and str(msg.get("key", "")).startswith(self._prefix):
            with self._cv:
                self._cv.notify_all()

    def _key(self, step: int, mb: int, kind: str) -> str:
        return f"{self._prefix}/{int(step)}/{int(mb)}/{kind}"

    # --------------------------------------------------------------- send

    def send(self, step: int, mb: int, kind: str, tree: Any) -> int:
        """Chunk `tree` into this process's store and register the
        descriptor with the conductor mailbox. Returns payload bytes."""
        refs, desc = chunks.put_tree(self._worker, tree)
        desc.update(step=int(step), mb=int(mb), kind=kind,
                    src=self.src, dst=self.dst, ts=time.time())
        with self._lock:
            self._held[(int(step), int(mb), kind)] = refs
            # retention window: current + previous step per slot
            pruned = [k for k in self._held if k[0] <= int(step) - 2]
            for k in pruned:
                del self._held[k]
        if pruned:
            self._discard_mailbox(pruned)
        res = self._worker.conductor.call(
            "pipeline_channel_put", self._key(step, mb, kind), desc,
            timeout=30.0)
        if isinstance(res, dict) and res.get("error"):
            with self._lock:
                self._held.pop((int(step), int(mb), kind), None)
            raise RuntimeError(
                f"pipeline channel send rejected: {res['error']}")
        nbytes = int(desc["total_bytes"])
        self.stats.sent_msgs += 1
        self.stats.sent_chunks += len(refs)
        self.stats.sent_bytes += nbytes
        self.stats.per_kind[f"sent_{kind}"] = \
            self.stats.per_kind.get(f"sent_{kind}", 0) + 1
        pipeline_metrics()["activations_bytes"].inc(
            nbytes, tags={"pipeline": self.name,
                          "stage": str(self.stage),
                          "direction": "send"})
        return nbytes

    # --------------------------------------------------------------- recv

    def _take_descriptor(self, step: int, mb: int, kind: str,
                         timeout: float) -> Dict[str, Any]:
        """Poll the mailbox until (step, mb, kind) is deliverable (the
        pubsub wakeup shortens the poll); single delivery — the caller
        owns the descriptor."""
        key = self._key(step, mb, kind)
        deadline = time.monotonic() + timeout
        while True:
            desc = self._worker.conductor.call("pipeline_channel_take",
                                               key, timeout=30.0)
            if desc is not None:
                return desc
            if self._closed:
                raise RuntimeError(
                    f"pipeline {self.name!r}: channel "
                    f"{self.src}->{self.dst} closed while waiting for "
                    f"{kind} microbatch {mb} of step {step}")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"pipeline {self.name!r}: stage {self.dst} waited "
                    f"{timeout}s for {kind} microbatch {mb} of step "
                    f"{step} from stage {self.src} — upstream stage "
                    "dead or wedged?")
            with self._cv:
                self._cv.wait(min(remaining, self._poll))

    def prefetch(self, step: int, mb: int, kind: str,
                 timeout: float = 60.0) -> None:
        """Start pulling (step, mb, kind) in the BACKGROUND so a later
        recv() finds the chunks already fetched — issued during stage
        compute, the same prefetch shape as ``WeightSync(prefetch=
        True)``: the transfer overlaps compute and only the residual
        wait lands in ``bubble_wait``. Idempotent per slot; errors
        surface at the consuming recv()."""
        key3 = (int(step), int(mb), kind)
        with self._lock:
            if self._closed or key3 in self._prefetched:
                return
            rec: Dict[str, Any] = {"done": threading.Event(),
                                   "tree": None, "fetcher": None,
                                   "desc": None, "error": None}
            self._prefetched[key3] = rec

        def pull():
            try:
                desc = self._take_descriptor(step, mb, kind, timeout)
                # record the take IMMEDIATELY: delivery is single-shot,
                # so recv() must be able to tell "descriptor consumed,
                # fetch failed" (not retryable) apart from "take timed
                # out" (retryable on recv's own budget)
                rec["desc"] = desc
                fetcher = chunks.ChunkFetcher(self._worker,
                                              caller="activations")
                rec["tree"] = chunks.fetch_tree(self._worker, desc,
                                                fetcher)
                rec["fetcher"] = fetcher
            except Exception as e:  # noqa: BLE001 — re-raised at recv
                rec["error"] = e
            finally:
                rec["done"].set()

        threading.Thread(
            target=pull, daemon=True,
            name=f"chan-prefetch-{self.src}to{self.dst}").start()

    def recv(self, step: int, mb: int, kind: str,
             timeout: float = 60.0) -> Any:
        """Block until the (step, mb, kind) payload is deliverable,
        then pull its chunks point-to-point from the sender (or adopt
        the in-flight prefetch's pull). The blocked time accumulates
        into ``stats.wait_s`` (the caller additionally times it into
        the StepTimer's ``bubble_wait`` phase)."""
        key3 = (int(step), int(mb), kind)
        with self._lock:
            pre = self._prefetched.pop(key3, None)
        t0 = time.monotonic()
        if pre is not None:
            if not pre["done"].wait(timeout):
                # still in flight: re-stash so a RETRIED recv adopts the
                # pull once it lands — dropping the record here would
                # orphan a descriptor the thread consumes moments later
                # (single delivery: no fresh take could ever succeed)
                with self._lock:
                    self._prefetched.setdefault(key3, pre)
                raise TimeoutError(
                    f"pipeline {self.name!r}: prefetch of {kind} "
                    f"microbatch {mb} of step {step} from stage "
                    f"{self.src} did not finish within {timeout}s")
            if isinstance(pre["error"], TimeoutError) \
                    and pre["desc"] is None:
                # the background take timed out against the PREFETCH
                # issuance clock WITHOUT consuming the descriptor — a
                # slow upstream may have published since, so fall back
                # to a fresh take on recv's own budget (pre-prefetch
                # behavior) instead of failing a recv that would have
                # succeeded. A fetch timeout AFTER the take (desc set)
                # is NOT retryable — delivery is single-shot — so it
                # re-raises below like any other prefetch error.
                pre = None
            elif pre["error"] is not None:
                raise pre["error"]
        if pre is not None:
            self.stats.wait_s += time.monotonic() - t0
            self.stats.prefetch_hits += 1
            desc, fetcher, tree = pre["desc"], pre["fetcher"], \
                pre["tree"]
        else:
            remaining = max(0.0, timeout - (time.monotonic() - t0))
            desc = self._take_descriptor(step, mb, kind, remaining)
            self.stats.wait_s += time.monotonic() - t0
            fetcher = chunks.ChunkFetcher(self._worker,
                                          caller="activations")
            tree = chunks.fetch_tree(self._worker, desc, fetcher)
        nbytes = int(desc["total_bytes"])
        self.stats.recv_msgs += 1
        self.stats.recv_chunks += len(desc["leaves"])
        self.stats.recv_bytes += nbytes
        self.stats.fetched_remote_chunks += fetcher.chunks_fetched
        self.stats.fetched_remote_bytes += fetcher.fetched_bytes
        self.stats.max_fetch_bytes = max(
            self.stats.max_fetch_bytes,
            max((int(e["nbytes"]) for e in desc["leaves"]), default=0))
        self.stats.per_kind[f"recv_{kind}"] = \
            self.stats.per_kind.get(f"recv_{kind}", 0) + 1
        pipeline_metrics()["activations_bytes"].inc(
            nbytes, tags={"pipeline": self.name,
                          "stage": str(self.stage),
                          "direction": "recv"})
        return self._place(tree)

    def _place(self, tree: Any) -> Any:
        """Every leaf as a tensor on this endpoint's device, in its
        dtype (no-op without a device)."""
        if self.device is None:
            return tree
        import torch

        from ..tree import tree_map

        def place(leaf):
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.array(leaf))
            return leaf.to(self.device)

        return tree_map(place, tree)

    # -------------------------------------------------------------- close

    def drain(self, timeout: float = 10.0) -> bool:
        """Sender-side close barrier: block until every descriptor this
        endpoint registered has been TAKEN by the receiver. The refs
        this channel holds ARE the chunks' lifetime, so close() right
        after the final send would race the store free against the
        receiver's last fetch — once the mailbox entry is taken, the
        receiver constructs its borrowing ObjectRef within the free
        grace window and the chunks are safe to drop. Returns False on
        timeout (receiver dead; the caller closes anyway)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                keys = [self._key(s, mb, k) for (s, mb, k)
                        in self._held]
            if not keys:
                return True
            pending = self._worker.conductor.call(
                "pipeline_channel_pending", keys, timeout=30.0)
            if not pending:
                return True
            if time.monotonic() > deadline:
                return False
            with self._cv:
                self._cv.wait(self._poll)

    def held_slots(self) -> List[Tuple[int, int, str]]:
        with self._lock:
            return sorted(self._held)

    def _discard_mailbox(self, slots: List[Tuple[int, int, str]]) -> None:
        """Best-effort: tell the conductor to drop undelivered
        descriptors whose chunks are being freed — a descriptor naming
        dead chunks must neither stay deliverable (a late recv would
        hit an opaque fetch timeout instead of the channel's clear
        one) nor leak toward the mailbox cap."""
        try:
            self._worker.conductor.notify(
                "pipeline_channel_discard",
                [self._key(s, mb, k) for (s, mb, k) in slots])
        except Exception:  # noqa: BLE001 — conductor mid-shutdown
            pass

    def close(self) -> None:
        """Drop every held chunk (and its undelivered descriptors)
        and the pubsub callback; in-flight prefetch polls exit on the
        closed flag."""
        self._closed = True
        with self._cv:
            self._cv.notify_all()  # wake prefetch polls so they exit
        try:
            self._worker.unsubscribe_channel("pipeline", self._on_msg)
        except Exception:  # noqa: BLE001 — worker already torn down
            pass
        with self._lock:
            slots = list(self._held)
            self._held.clear()
            self._prefetched.clear()
        if slots:
            self._discard_mailbox(slots)


__all__ = ["ActivationChannel", "ChannelStats"]
