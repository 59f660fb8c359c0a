"""WeightSync: keep a serving engine on the latest published weights
(port of ray_tpu/weights/sync.py).

A background thread (nudged by pubsub, backed by a poll) watches the
registry; on a new version it reshards-on-fetch under the consumer's own
template and queues a swap that the continuous-batching engine
(`models.engine.ContinuousBatchingEngine.update_params`) applies BETWEEN
decode ticks: in-flight requests keep their KV rows and complete,
nothing restarts. Staleness (latest published version minus the version
served) is sampled every cycle, and also the moment a new version is
noticed, before its fetch: that sample is the lag a reader of this
replica sees while the fetch and the swap run. Each applied swap writes
a marker to the conductor's weight event log.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .subscriber import WeightSubscriber

logger = logging.getLogger("ray_tpu_torch.weights")


class WeightSync:
    """Drives one engine (anything with ``update_params(params,
    version)`` and a ``params_version`` attribute) from one named weight
    set."""

    def __init__(self, engine: Any, name: str = "default", *,
                 template: Any = None, consumer: str = "",
                 poll_interval_s: float = 0.5,
                 subscriber: Optional[WeightSubscriber] = None,
                 prefetch: bool = False):
        self.engine = engine
        self.name = name
        # the reshard target: the engine's current params by default
        # (their devices, dtypes and layouts ARE the serving layout)
        self.template = template if template is not None else engine.params
        self.consumer = consumer or f"pid-{os.getpid()}"
        self.poll_interval_s = poll_interval_s
        self._sub = subscriber or WeightSubscriber(
            name, cache_chunks=prefetch)
        self._stop = threading.Event()
        self._swapped = threading.Condition()
        self.swap_count = 0
        self.last_error: Optional[str] = None
        # staleness high-water mark over this sync's life
        self.max_staleness: Optional[int] = None
        self.staleness_samples: List[int] = []
        # each applied swap: version, the staleness when it was noticed,
        # the fetch's and the swap's time
        self.swaps: List[Dict[str, Any]] = []
        # False the moment a registry probe fails, True again on the next
        # healthy cycle: "fresh" apart from "the registry stopped
        # answering"
        self.registry_reachable = True
        # a pubsub "published" notice pulls the new version's chunks on a
        # side thread while the engine still decodes the old one
        self.prefetch = prefetch
        self.prefetch_bytes = 0
        self.prefetched_version: Optional[int] = None
        self._prefetch_lock = threading.Lock()
        if prefetch:
            self._sub._worker.subscribe_channel("weights",
                                                self._on_published)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"weight-sync-{name}")
        self._thread.start()

    # ----------------------------------------------------------- prefetch

    def _on_published(self, msg: Any) -> None:
        if not isinstance(msg, dict) or msg.get("name") != self.name \
                or msg.get("kind") != "published":
            return
        threading.Thread(target=self._prefetch_one,
                         args=(msg.get("version"),), daemon=True,
                         name=f"weight-prefetch-{self.name}").start()

    def _prefetch_one(self, version) -> None:
        with self._prefetch_lock:  # one transfer at a time
            if self._stop.is_set():
                return
            try:
                st = self._sub.prefetch(version=version)
            except Exception:  # noqa: BLE001 — version GC'd or reaped
                return         # between notice and pull; fetch retries
            self.prefetch_bytes += st.fetched_bytes
            self.prefetched_version = st.version

    # ------------------------------------------------------------- status

    def _sample(self, latest: Optional[int]) -> Optional[int]:
        """Staleness now, or None while unknowable (no fabric version
        served yet, or the registry unreachable)."""
        serving = getattr(self.engine, "params_version", None)
        if latest is None or serving is None or not self.registry_reachable:
            return None
        staleness = latest - serving
        self.max_staleness = staleness if self.max_staleness is None \
            else max(self.max_staleness, staleness)
        self.staleness_samples.append(staleness)
        return staleness

    def status(self) -> Dict[str, Any]:
        latest = None
        try:
            latest = self._sub.latest_version()
            self.registry_reachable = True
        except Exception as e:  # noqa: BLE001 — conductor unreachable
            self.last_error = str(e)
            self.registry_reachable = False
        staleness = self._sample(latest)
        st = self._sub.last_stats
        return {"name": self.name, "consumer": self.consumer,
                "serving_version": getattr(self.engine, "params_version",
                                           None),
                "latest_version": latest,
                "registry_reachable": self.registry_reachable,
                "staleness_versions": staleness,
                "max_staleness_versions": self.max_staleness,
                "swap_count": self.swap_count,
                "swaps": list(self.swaps),
                "fetched_bytes": st.fetched_bytes if st else 0,
                "rpc_bytes": st.rpc_bytes if st else 0,
                "shm_bytes": st.shm_bytes if st else 0,
                "max_read_bytes": st.max_read_bytes if st else 0,
                "leaf_read_bytes": list(st.leaf_read_bytes) if st else [],
                "prefetch_bytes": self.prefetch_bytes,
                "prefetched_version": self.prefetched_version,
                "last_error": self.last_error}

    def stats(self) -> Dict[str, Any]:
        """The sync's numbers: its swaps (each fetch's time and bytes and
        the swap's own time), the staleness samples and the
        subscriber's."""
        return {"name": self.name, "consumer": self.consumer,
                "swap_count": self.swap_count, "swaps": list(self.swaps),
                "staleness_samples": list(self.staleness_samples),
                "max_staleness_versions": self.max_staleness,
                "subscriber": self._sub.stats()}

    def wait_for_swap(self, min_version: int, timeout: float = 30.0) -> int:
        """Block until the ENGINE serves a version >= min_version (applied
        between ticks, not merely queued)."""
        deadline = time.monotonic() + timeout
        with self._swapped:
            while True:
                v = getattr(self.engine, "params_version", None)
                if v is not None and v >= min_version:
                    return v
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"engine still serving {v} (< {min_version}) "
                        f"after {timeout}s; last_error={self.last_error}")
                self._swapped.wait(min(remaining, 0.2))

    # --------------------------------------------------------------- loop

    def _engine_stopped(self) -> bool:
        stopped = getattr(self.engine, "_stopped", None)
        return stopped is not None and stopped.is_set()

    def _loop(self) -> None:
        failed_cycles = 0
        while not self._stop.is_set():
            if self._engine_stopped():
                # a queued swap would never apply, and every cycle would
                # fetch the whole model again
                self.last_error = "engine stopped; weight sync idle"
                return
            try:
                latest = self._sub.latest_version()
                self.registry_reachable = True
                serving = getattr(self.engine, "params_version", None)
                # follow whatever the registry calls latest (committed
                # last), not `>`: a gang restarted from an older
                # checkpoint publishes LOWER versions, the live weights
                if latest is not None and latest != serving:
                    noticed = self._sample(latest)
                    if self.prefetch:
                        self._prefetch_one(latest)
                    t0 = time.perf_counter()
                    params = self._sub.fetch(version=latest,
                                             like=self.template)
                    t1 = time.perf_counter()
                    applied = self.engine.update_params(params,
                                                        version=latest)
                    if applied is not None and \
                            not applied.wait(timeout=60.0):
                        raise RuntimeError(
                            f"swap to v{latest} not applied within 60s "
                            "(decode loop wedged or engine stopped)")
                    t2 = time.perf_counter()
                    # the template follows the weights being served (same
                    # layout): keeping the original would pin a dead copy
                    self.template = params
                    self.swap_count += 1
                    st = self._sub.last_stats
                    self.swaps.append({
                        "version": latest, "staleness_at_notice": noticed,
                        "fetch_ms": (t1 - t0) * 1e3,
                        "apply_ms": (t2 - t1) * 1e3,
                        "fetched_bytes": st.fetched_bytes if st else 0,
                        "applied_at": time.time()})
                    try:
                        self._sub._worker.conductor.notify(
                            "report_weight_event", {
                                "kind": "swap", "name": self.name,
                                "version": latest,
                                "consumer": self.consumer,
                                "fetched_bytes":
                                    st.fetched_bytes if st else 0})
                    except Exception:  # noqa: BLE001 — telemetry only
                        pass
                    with self._swapped:
                        self._swapped.notify_all()
                self._sample(latest)
                failed_cycles = 0
                self.last_error = None
            except Exception as e:  # noqa: BLE001 — keep serving on a
                # failed cycle (registry mid-restart, a version GC'd
                # between list and fetch); the next cycle retries
                failed_cycles += 1
                self.last_error = f"{type(e).__name__}: {e}"
                self.registry_reachable = False
                logger.debug("weight sync cycle failed: %s", e)
            # publish notices wake the subscriber's condition; failed
            # cycles back off
            wait_s = self.poll_interval_s if not failed_cycles else \
                min(self.poll_interval_s * (2 ** failed_cycles), 30.0)
            with self._sub._cv:
                self._sub._cv.wait(wait_s)

    def stop(self) -> None:
        self._stop.set()
        if self.prefetch:
            try:
                self._sub._worker.unsubscribe_channel(
                    "weights", self._on_published)
            except Exception:  # noqa: BLE001 — worker already torn down
                pass
        with self._sub._cv:
            self._sub._cv.notify_all()
        self._thread.join(timeout=10.0)
        self._sub.close()
