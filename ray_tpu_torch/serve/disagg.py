"""Disaggregated prefill / decode serving (port of
ray_tpu/serve/disagg.py): prefill replicas stream a prompt's KV rows to
decode replicas over the chunk fabric.

- **PrefillServer** runs the engine's prefill behind the paged prefix
  cache (``models/kvcache.py``, with the KV plane's host arena as its
  tier 2), then publishes the prompt's KV rows and first token through
  ``util/chunks``: the rows go into the server's OWN object store and
  only a descriptor travels the control plane. A CUDA tensor is copied
  to the host once, by that put; nothing else copies it. The server's
  refs are the chunks' lifetime: ``ack()`` drops them, and a bounded
  retention window reaps transfers nobody acked. Without a cluster the
  rows ride the record itself (``kv_inline``).
- **DecodeServer** pulls the rows point to point (``ChunkFetcher(caller=
  "kv")``, shm vs rpc accounted) and adopts them into its engine's decode
  slab (``ContinuousBatchingEngine.adopt_prefill``), which moves them to
  its device; its engine has no prefix cache and never prefills
  (``prefill_programs()`` counts this process's prefills).
- **DisaggRouter** picks the prefill replica by prefix affinity (a
  stable hash of the prompt's first ``affinity_tokens``), upgraded by
  the KV plane's prefix directory to the replica that holds the prefix,
  and the decode replica by free slots; with no prefill tier it is the
  colocated engine, bit-identical. Admission is bounded at capacity +
  ``max_queue_depth`` per decode replica: past it a request is shed with
  a ``RequestShedError`` (``retry_after_s``).

The router owns request-level fault tolerance: an ACCEPTED request
either streams to completion or sheds with a cause. Decode streams cross
the actor boundary as chunked pulls (``start_decode`` / ``next_tokens``),
so the router always holds the tokens so far; when a decode replica dies
mid-stream, the router prefills the prompt plus that history again (a
suffix-only prefill, thanks to the prefix cache) and resumes on a
survivor, bit-identical to an uninterrupted greedy run. A prefill death
retries on another replica. Attempts are bounded (``failover_attempts``
extra, default 2): exhaustion sheds with cause ``failover``, a request
past its ``deadline_s`` with cause ``deadline``. A ``priority="batch"``
stream may be preempted by an ``interactive`` arrival and resumes by the
same replay.

Where the port differs: the JAX package's knobs are arguments with its
defaults (``RAY_TPU_DISAGG_QUEUE_DEPTH`` 8, ``RAY_TPU_DISAGG_RETRY_AFTER_S``
1.0, ``RAY_TPU_FAILOVER_ATTEMPTS`` 2, the KV plane's,
``RAY_TPU_AUTOSCALE_WINDOW_S`` 30 as the router's ``window_s``, the span
of its recent-signal windows); servers take
``device=`` (CUDA unless the caller asks for the CPU; without CUDA they
raise) and move the params there; ``prefill_programs()`` counts prefills
run in the process (``models.engine.prefill_paged_calls``), as the port
has no compile cache; a ``kill_replica`` chaos fire in a driver raises.
``disagg_metrics()`` and ``servefault_metrics()`` are the JAX package's
``ray_tpu_disagg_*`` / ``ray_tpu_servefault_*`` families on
``util.metrics``, so a decode actor's counters reach the driver's
``util.state.prometheus_metrics()`` through its own registry push; the
conductor aggregates the servers' and routers' snapshots (``util.state.disagg_status()``, ``kvplane_status()``,
``servefault_status()``) and the timeline's ``disagg`` / ``kvplane``
lanes carry the markers (failovers in the resilience lane).

The request flight recorder (``observability/requests.py``) rides the
router as in the JAX package: ``generate`` takes over the thread's
current trace or mints one, stamps ``queue_reserve``, ``prefill``,
``kv_transfer``, ``decode_first_token`` and ``decode_steady`` (a
failover's replay under its attempt number), and a decode actor pushes
its fetch as a remote phase under the request's id. The servers push
their pools' kvcache and LoRA telemetry beside their own.

The HTTP gateway (``serve/gateway.py``) hangs on ``generate``: its
``cancel_event`` sheds the request with cause ``disconnect`` (the engine
slot is cancelled under that reason), and a fired preemption counts
into ``gateway_metrics()["preemptions"]`` with a ``preempt`` gateway
event.

On a LoRA router a serve request's multiplexed model id is the default
``tenant`` (``serve/multiplex.py``'s ``request_tenant``).

Not ported with it: the load harness's (``reset_signal_windows``, the servers'
``reset_chaos_counts``), and the servers' local adapter publish
(``publish_adapter`` / ``refresh_adapter``; a replica's tenants come
from its ``lora=``). The
replica-set operations (``add_*``, ``begin_drain``, ``drained``,
``remove``, ``remove_dead``, ``set_tier_waker``) are what
``serve/autoscale.py``'s ``DisaggAutoscaler`` drives: SLO scaling,
graceful drains and the self-healer.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..exceptions import ActorError, WorkerCrashedError
from ..observability import requests as reqtrace
from ..tree import tree_map
from . import kvplane as kvp
from .autoscale import TARGET_P99_MS, WINDOW_S, SlidingWindow
from .handle import RequestShedError, shed_counter

_SERVER_SEQ = itertools.count()

# the JAX package's knob defaults
QUEUE_DEPTH = 8
RETRY_AFTER_S = 1.0
FAILOVER_ATTEMPTS = 2

# failures that mean "the replica's process is gone": the corpse leaves
# the replica set and the request retries elsewhere. Anything else is a
# request failure: it uses up an attempt, the replica stays.
_DEATH_TYPES = (ActorError, WorkerCrashedError, ConnectionError, EOFError,
                OSError)


def _is_pool_exhausted(e: BaseException) -> bool:
    """An adapter pool with every row pinned (serve/lora.py
    LoraPoolExhausted, matched by name: it may arrive re-wrapped across
    the actor boundary): a capacity condition, shed at once."""
    return "LoraPoolExhausted" in repr(e)


# a tenant's configuration errors: retrying reproduces them, so they
# reach the caller as the ValueError they are
_LORA_CONFIG_ERRORS = ("no adapter registered for tenant",
                       "exceeds the pool's rank_max", "has no lora_pool",
                       "has no adapter pool",
                       "does not fit this model's target")


def _is_lora_config_error(e: BaseException) -> bool:
    r = repr(e)
    if any(m in r for m in _LORA_CONFIG_ERRORS):
        return True
    return "no committed version" in r and "lora/" in r


class ReplicaDeadError(RuntimeError):
    """A tier replica's call failed because the replica died."""

    def __init__(self, tier: str, rid: str, cause: BaseException):
        super().__init__(f"{tier} replica {rid} died: "
                         f"{type(cause).__name__}: {cause}")
        self.tier = tier
        self.rid = rid
        self.cause = cause


# ------------------------------------------------------ prometheus (lazy)
# Created on first use, never at import: importing the module starts no
# metrics pusher.

_metrics: Optional[Dict[str, Any]] = None
_sf_metrics: Optional[Dict[str, Any]] = None
_metrics_lock = threading.Lock()


def disagg_metrics() -> Dict[str, Any]:
    """The ``ray_tpu_disagg_*`` family on ``util.metrics`` (JAX's names,
    help and tags), created on first use."""
    global _metrics
    m = _metrics
    if m is not None:
        return m
    with _metrics_lock:
        if _metrics is None:
            from ..util.metrics import Counter, Gauge

            _metrics = dict(
                kv_bytes=Counter(
                    "ray_tpu_disagg_kv_bytes_total",
                    "KV-block bytes moved between prefill and decode "
                    "replicas over the chunk fabric",
                    tag_keys=("direction",)),
                transfers=Counter(
                    "ray_tpu_disagg_transfers_total",
                    "completed prefill->decode KV transfers (counted "
                    "when the decode replica's fetch finishes)"),
                queue_depth=Gauge(
                    "ray_tpu_disagg_queue_depth",
                    "requests in flight through a disagg router "
                    "(executing + queued at its decode tier)",
                    tag_keys=("router",)))
    return _metrics


def servefault_metrics() -> Dict[str, Any]:
    """The ``ray_tpu_servefault_*`` family on ``util.metrics`` (JAX's
    names, help and tags), created on first use."""
    global _sf_metrics
    m = _sf_metrics
    if m is not None:
        return m
    with _metrics_lock:
        if _sf_metrics is None:
            from ..util.metrics import Counter

            _sf_metrics = dict(
                failovers=Counter(
                    "ray_tpu_servefault_failovers_total",
                    "request failover attempts after a tier-replica "
                    "failure (phase=prefill|decode)",
                    tag_keys=("phase",)),
                sheds=Counter(
                    "ray_tpu_servefault_sheds_total",
                    "requests shed with an attributed cause "
                    "(capacity|deadline|failover|draining)",
                    tag_keys=("cause",)),
                replacements=Counter(
                    "ray_tpu_servefault_replacements_total",
                    "dead tier replicas replaced by the self-healer "
                    "(serve/autoscale.py)",
                    tag_keys=("tier",)),
                breaker_trips=Counter(
                    "ray_tpu_servefault_breaker_trips_total",
                    "replacement circuit-breaker OPEN transitions (a "
                    "host whose replicas die repeatedly stops getting "
                    "replacements)"))
    return _sf_metrics


def _worker():
    from .._private import worker as worker_mod

    return worker_mod.global_worker


def _notify(method: str, *args: Any) -> None:
    """Best-effort push to the conductor; nothing without a cluster."""
    w = _worker()
    if w is None:
        return
    try:
        w.conductor.notify(method, *args)
    except Exception:  # noqa: BLE001 — cluster shutting down
        pass


def _notify_event(event: Dict[str, Any]) -> None:
    _notify("report_disagg_event", dict(event))


def _notify_kvplane(event: Dict[str, Any]) -> None:
    _notify("report_kvplane_event", dict(event))


def _push(method: str, component_id: str, stats: Dict[str, Any]) -> None:
    w = _worker()
    if w is not None:
        _notify(method, w.worker_id, component_id, stats)


def _call(target: Any, method: str, *args, block: bool = True, **kw):
    """Call `method` on a local component or an actor handle (the router
    takes either)."""
    fn = getattr(target, method)
    remote = getattr(fn, "remote", None)
    if remote is not None:
        import ray_tpu_torch as rt

        ref = remote(*args, **kw)
        return rt.get(ref) if block else ref
    return fn(*args, **kw)


def _to_device(params: Any, device: Any) -> Tuple[Any, torch.device]:
    """The param tree on `device` (CUDA unless asked otherwise: without
    CUDA this raises, so no replica serves on the CPU by accident)."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params), dev


def _empty_prefix(config: Any, device: torch.device) -> torch.Tensor:
    """[L, 0, H, hd] in the cache dtype: the uncached prefill's prefix."""
    from ..models.generate import _model_fns

    probe = _model_fns(config)[1](config, 1, max_len=1, device=device)
    k = probe[0]["k"]
    return torch.zeros((len(probe), 0) + tuple(k.shape[2:]), dtype=k.dtype,
                       device=device)


# ------------------------------------------------------------ prefill tier

class PrefillServer:
    """One prefill replica: prefill behind the prefix cache, KV rows
    published as sender-owned chunks.

    ``prefill()`` returns a metadata record a DecodeServer adopts: the
    first token and its logprob, the prefix-cache outcome and the chunk
    descriptor of the KV rows. The prompt's cache pins drop as soon as
    the rows are exported; the blocks stay cached."""

    def __init__(self, params: Any, config: Any, *, prefix_cache: bool = True,
                 kv_block_size: int = 16, kv_pool_blocks: int = 0,
                 kv_int8: bool = False, retain: int = 32,
                 server_id: Optional[str] = None, chaos: Any = None,
                 chaos_replica: int = 0, lora: Any = None,
                 lora_pool_slots: int = 8, lora_rank_max: int = 8,
                 kvplane: bool = True,
                 kvplane_arena_bytes: int = kvp.ARENA_BYTES,
                 directory: bool = True,
                 t3_min_blocks: int = kvp.T3_MIN_BLOCKS,
                 device: Any = "cuda"):
        from ..models.kvcache import PagedKVCache, resolve_pool_config
        from ..resilience.chaos import serve_monkey_from_spec
        from ..util.chunks import local_machine_id
        from .lora import build_pool

        self.params, self.device = _to_device(params, device)
        self.config = config
        self.server_id = server_id or f"pf-{os.getpid()}-{next(_SERVER_SEQ)}"
        self.machine = local_machine_id()
        # scripted faults (kill_replica, evict_storm)
        self._chaos = serve_monkey_from_spec(chaos, "prefill", chaos_replica)
        self.kv_int8 = bool(kv_int8)
        block_size, pool_blocks = resolve_pool_config(
            config, kv_block_size, kv_pool_blocks, int8=self.kv_int8)
        self.kv_cache: Optional[PagedKVCache] = (
            PagedKVCache(config, block_size=block_size,
                         num_blocks=pool_blocks, int8=self.kv_int8,
                         device=self.device)
            if prefix_cache else None)
        # the KV plane: a host arena catches evicted blocks (tier 2), and
        # hot prefixes are published to the directory (tier 3)
        self.kvplane = bool(kvplane) and self.kv_cache is not None
        self.directory = bool(directory)
        self.t3_min_blocks = int(t3_min_blocks)
        self.arena: Optional[kvp.HostArena] = None
        if self.kvplane:
            self.arena = kvp.HostArena(max_bytes=kvplane_arena_bytes,
                                       replica=self.server_id)
            self.kv_cache.attach_arena(self.arena)
        # multi-tenant LoRA: prefill under each request's adapter; a hot
        # swap reclaims that tenant's old blocks
        self.lora_pool = build_pool(config, lora, slots=lora_pool_slots,
                                    rank_max=lora_rank_max,
                                    device=self.device)
        if self.lora_pool is not None and self.kv_cache is not None:
            self.lora_pool.add_swap_listener(
                lambda tenant, old, _p=self.lora_pool:
                self.kv_cache.invalidate(
                    namespace=_p.cache_namespace(tenant, old)))
        self._empty_prefix = _empty_prefix(config, self.device)
        # unacked transfers kept alive; size past the decode tier's
        # admitted bound (replicas x (max_batch + queue depth)), or a
        # transfer is reaped just before it is fetched
        self._retain = max(1, int(retain))
        self._lock = threading.Lock()
        # transfer id -> chunk refs (holding them is the chunks' lifetime)
        self._held: "OrderedDict[str, List[Any]]" = OrderedDict()
        # tier-3 holder state: digest -> (namespace, refs), keep-last-K;
        # _t3_known throttles re-publish attempts
        self._t3_refs: "OrderedDict[str, tuple]" = OrderedDict()
        self._t3_known: "OrderedDict[str, bool]" = OrderedDict()
        self._t3_keep = 8
        self._kvp_stats = {k: 0 for k in (
            "tier3_publishes", "tier3_adopts", "tier3_adopted_blocks",
            "tier3_reused_tokens", "tier3_fetched_bytes",
            "evict_storms", "storm_evicted_blocks")}
        self._seq = itertools.count()
        self._stats = {k: 0 for k in (
            "prefills", "prefilled_tokens", "reused_tokens",
            "published_transfers", "published_bytes", "acked",
            "reaped_unacked")}
        # ms of each publish (the put into this server's store), newest
        # last
        self._publish_ms: List[float] = []
        self._last_push = 0.0
        disagg_metrics()

    # ---------------------------------------------------------- data plane

    def prefill(self, prompt_tokens, tenant: Optional[str] = None,
                kvplane_hint: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """Prefill one prompt (suffix only on a cache hit) and publish
        its KV rows; returns the transfer record. `tenant`: prefill under
        that tenant's adapter, cached in its namespace. `kvplane_hint`: a
        directory entry whose holder the router could not route to; this
        replica fetches that prefix and adopts it before the lookup (a
        failed fetch only means a longer prefill)."""
        with torch.inference_mode():
            return self._prefill(prompt_tokens, tenant, kvplane_hint)

    def _prefill(self, prompt_tokens, tenant, kvplane_hint):
        from ..models.engine import _prefill_with_cache
        from ..util import chunks

        if self._chaos is not None:
            self._chaos.on_request()  # may end the process (kill_replica)
            storm = self._chaos.take_storm()
            if storm and self.kv_cache is not None:
                evicted = self.kv_cache.force_evict(storm)
                with self._lock:
                    self._kvp_stats["evict_storms"] += 1
                    self._kvp_stats["storm_evicted_blocks"] += evicted
                _notify_kvplane({"kind": "evict_storm",
                                 "replica": self.server_id,
                                 "blocks": evicted, "requested": storm})
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        plen = prompt.shape[1]
        if plen < 1:
            raise ValueError("empty prompt")
        adapter = namespace = None
        if tenant is not None:
            if self.lora_pool is None:
                raise ValueError(
                    f"request for tenant {tenant!r} but this prefill "
                    f"server has no adapter pool (lora= ctor arg)")
            adapter, aver = self.lora_pool.adapter_slice(
                self.lora_pool.acquire(tenant), with_version=True)
            namespace = self.lora_pool.cache_namespace(tenant, aver)
        kvp_info: Dict[str, Any] = {}
        if self.arena is not None:
            self.arena.begin_request()
        if kvplane_hint is not None and self.kvplane \
                and _worker() is not None:
            t3 = self._adopt_t3(kvplane_hint, prompt[0], namespace)
            if t3 is not None:
                kvp_info["tier3"] = t3
        try:
            ck, cv, table, first, score, outcome, reused, suffix_len = \
                _prefill_with_cache(self.params, self.config, self.kv_cache,
                                    prompt, self._empty_prefix,
                                    adapter=adapter, namespace=namespace)
        finally:
            if adapter is not None:
                self.lora_pool.release(tenant)
        if self.kv_cache is not None:
            self.kv_cache.release(table)
        if self.arena is not None:
            t2 = self.arena.end_request()
            if t2.get("blocks"):
                kvp_info["tier2"] = t2
        # the payload: the prompt's KV rows, views of the filled window;
        # put_tree copies them to the host once (a CUDA tensor), and the
        # inline form hands the views on as they are
        kv_k, kv_v = ck[:, :plen], cv[:, :plen]
        rec: Dict[str, Any] = {
            "transfer_id": f"{self.server_id}-{next(self._seq)}",
            "plen": plen, "first_token": first, "score": score,
            "outcome": outcome, "reused_tokens": int(reused),
            "prefill_server": self.server_id,
            # the prompt rides the record, so the decode side's proposer
            # drafts from it
            "prompt_tokens": [int(t) for t in prompt[0]],
        }
        if tenant is not None:
            rec["tenant"] = tenant
        if kvp_info:
            rec["kvplane"] = kvp_info
        nbytes = int(kv_k.nbytes + kv_v.nbytes)
        w = _worker()
        if w is not None:
            t0 = time.perf_counter()
            refs, desc = chunks.put_tree(w, {"k": kv_k, "v": kv_v})
            publish_ms = (time.perf_counter() - t0) * 1e3
            rec["kv"] = desc
            del kv_k, kv_v, ck, cv
            with self._lock:
                self._publish_ms.append(publish_ms)
                del self._publish_ms[:-256]
                self._held[rec["transfer_id"]] = refs
                reaped = 0
                while len(self._held) > self._retain:
                    self._held.popitem(last=False)
                    reaped += 1
                self._stats["reaped_unacked"] += reaped
        else:
            rec["kv_inline"] = (kv_k, kv_v)
        # send is counted on both paths: the receiver counts recv for
        # inline adoptions too
        disagg_metrics()["kv_bytes"].inc(nbytes, tags={"direction": "send"})
        with self._lock:
            self._stats["prefills"] += 1
            self._stats["prefilled_tokens"] += suffix_len
            self._stats["reused_tokens"] += int(reused)
            self._stats["published_transfers"] += 1
            self._stats["published_bytes"] += nbytes
        _notify_event({"kind": "kv_publish", "server": self.server_id,
                       "transfer_id": rec["transfer_id"], "bytes": nbytes,
                       "plen": plen, "outcome": outcome})
        if w is not None and self.kvplane:
            self._maybe_publish_t3(prompt[0], namespace)
        self.publish_telemetry()
        return rec

    # -------------------------------------------- global KV plane (tier 3)

    def _adopt_t3(self, entry: Dict[str, Any], tokens,
                  namespace: Optional[str]) -> Optional[Dict[str, Any]]:
        """Fetch a directory entry's prefix and adopt it ahead of the
        lookup. Returns the fetch's attribution, or None when nothing
        crossed the wire."""
        t0 = time.perf_counter()
        try:
            adopted, fst = kvp.fetch_and_adopt(_worker(), self.kv_cache,
                                               entry, tokens, namespace)
        except Exception:  # noqa: BLE001 — never fail the prefill
            return None
        ms = (time.perf_counter() - t0) * 1e3
        fetched = int(fst.get("fetched_bytes", 0))
        reused = int(adopted) * self.kv_cache.block_size
        with self._lock:
            if adopted:
                self._kvp_stats["tier3_adopts"] += 1
                self._kvp_stats["tier3_adopted_blocks"] += int(adopted)
                self._kvp_stats["tier3_reused_tokens"] += reused
            self._kvp_stats["tier3_fetched_bytes"] += fetched
        if adopted:
            _notify_kvplane({"kind": "tier3_adopt",
                             "replica": self.server_id,
                             "blocks": int(adopted), "tokens": reused,
                             "nbytes": fetched, "namespace": namespace})
        if not adopted and not fetched:
            return None
        return {"blocks": int(adopted), "tokens": reused, "nbytes": fetched,
                "ms": round(ms, 3)}

    def _maybe_publish_t3(self, tokens, namespace: Optional[str]) -> None:
        """Publish the prompt's longest cached full-block prefix to tier 3
        (chunks plus the directory's commit), at most once a digest from
        this replica. Keep-last-K held refs; an evicted digest retracts
        its entry. Best effort throughout."""
        from ..models.kvcache import prefix_digests

        if not self.directory or self.kv_cache is None:
            return
        digs = prefix_digests(tokens, self.kv_cache.block_size, namespace)
        if len(digs) < self.t3_min_blocks:
            return
        head = digs[0]
        with self._lock:
            if head in self._t3_known:
                self._t3_known.move_to_end(head)
                return
        w = _worker()
        if w is None:
            return
        try:
            out = kvp.publish_prefix(w, self.kv_cache, tokens, namespace,
                                     self.server_id, machine=self.machine,
                                     min_blocks=self.t3_min_blocks)
        except Exception:  # noqa: BLE001 — directory outage
            return
        dropped: List[tuple] = []
        with self._lock:
            self._t3_known[head] = out is not None
            while len(self._t3_known) > 4 * self._t3_keep:
                self._t3_known.popitem(last=False)
            if out is not None:
                digest_hex, refs = out
                self._t3_refs[digest_hex] = (namespace, refs)
                self._kvp_stats["tier3_publishes"] += 1
                while len(self._t3_refs) > self._t3_keep:
                    old_digest, (old_ns, _refs) = \
                        self._t3_refs.popitem(last=False)
                    dropped.append((old_digest, old_ns))
        for old_digest, old_ns in dropped:
            try:
                w.conductor.call("kvplane_unpublish", old_ns or "",
                                 old_digest, timeout=5.0)
            except Exception:  # noqa: BLE001 — best-effort retract
                pass

    def kvplane_stats(self) -> Dict[str, Any]:
        """This replica's KV-plane snapshot: the arena, the tier-3
        counters and the fabric's per-caller accounting."""
        from ..util import chunks

        s: Dict[str, Any] = {"role": "prefill", "server_id": self.server_id,
                             "enabled": self.kvplane}
        if self.arena is not None:
            s.update(self.arena.stats())
        with self._lock:
            s.update(self._kvp_stats)
            s["t3_held_refs"] = len(self._t3_refs)
        s["fabric"] = chunks.caller_totals("kvplane")
        return s

    def set_retention(self, retain: int) -> None:
        """Raise the retention window (a router pushes the decode tier's
        admitted bound); never below the constructor's value."""
        with self._lock:
            self._retain = max(self._retain, int(retain))

    def ack(self, transfer_id: str) -> bool:
        """The receiver fetched: drop the chunks' refs. False if the
        retention window already reaped them."""
        with self._lock:
            held = self._held.pop(transfer_id, None)
            if held is not None:
                self._stats["acked"] += 1
        return held is not None

    def describe(self) -> Dict[str, Any]:
        """A router's registration record."""
        return {"server_id": self.server_id, "role": "prefill",
                "machine": self.machine, "lora": self.lora_pool is not None,
                "kvplane": self.kvplane,
                "kv_block_size": (self.kv_cache.block_size
                                  if self.kv_cache is not None else None)}

    def invalidate_prefix_cache(self) -> bool:
        """Drop the whole prefix index (every namespace)."""
        if self.kv_cache is None:
            return False
        self.kv_cache.invalidate()
        return True

    def prepare_for_shutdown(self, timeout_s: float = 30.0) -> bool:
        """Wait until every published transfer was acked (a decode
        replica may still be fetching), retract this holder's directory
        entries, and report whether the drain completed."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            with self._lock:
                held = len(self._held)
            if held == 0 or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        w = _worker()
        with self._lock:
            t3 = list(self._t3_refs.items())
            self._t3_refs.clear()
        if w is not None:
            for digest_hex, (ns, _refs) in t3:
                try:
                    w.conductor.call("kvplane_unpublish", ns or "",
                                     digest_hex, timeout=5.0)
                except Exception:  # noqa: BLE001 — conductor gone too
                    pass
        self.publish_telemetry(force=True)
        return held == 0

    # ------------------------------------------------------------ telemetry

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
            s["held_transfers"] = len(self._held)
        s["role"] = "prefill"
        s["server_id"] = self.server_id
        if self.kv_cache is not None:
            s["prefix_cache"] = self.kv_cache.stats()
        if self.lora_pool is not None:
            s["lora"] = self.lora_pool.stats()
        return s

    def publish_times(self) -> List[float]:
        """ms of each transfer's put into this server's store."""
        with self._lock:
            return list(self._publish_ms)

    def kv_stats(self) -> Dict[str, Any]:
        """The engine-shaped prefix-cache snapshot of the prefill tier."""
        s: Dict[str, Any] = (self.kv_cache.stats() if self.kv_cache
                             else {"enabled": False})
        with self._lock:
            s.update(engine_id=self.server_id, phase="prefill",
                     prefill_calls=self._stats["prefills"],
                     admitted=self._stats["prefills"],
                     prefill_admitted=self._stats["prefills"], adopted=0)
        return s

    def publish_telemetry(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_push < 0.5:
            return
        self._last_push = now
        if self.lora_pool is not None:
            self.lora_pool.publish_telemetry(force=force)
        if _worker() is None:
            if self.kv_cache is not None:
                self.kv_cache.drain_events()
            if self.arena is not None:
                self.arena.drain_events()
            return
        _push("report_disagg_stats", self.server_id, self.stats())
        _push("report_kvcache_stats", self.server_id, self.kv_stats())
        if self.kv_cache is not None:
            for ev in self.kv_cache.drain_events():
                ev.setdefault("engine", self.server_id)
                _notify("report_kvcache_event", ev)
        if self.kvplane:
            _push("report_kvplane_stats", self.server_id,
                  self.kvplane_stats())
            for ev in self.arena.drain_events():
                _notify_kvplane(ev)


# ------------------------------------------------------------- decode tier

class _CountedStream:
    """An adopted TokenStream that folds the tokens it yields into its
    DecodeServer's ``decoded_tokens``."""

    def __init__(self, server: "DecodeServer", stream: Any):
        self._server = server
        self._stream = stream

    def __iter__(self):
        n = 0
        try:
            for tok in self._stream:
                n += 1
                yield tok
        finally:
            self._server._count_decoded(n)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._stream, name)


class DecodeServer:
    """One decode replica: a batching engine with no prefix cache that
    only adopts prefilled KV and never runs a prefill."""

    _STREAM_REAP_S = 600.0

    def __init__(self, params: Any, config: Any, *, max_batch: int = 8,
                 server_id: Optional[str] = None, chaos: Any = None,
                 chaos_replica: int = 0, lora: Any = None,
                 lora_pool_slots: int = 8, lora_rank_max: int = 8,
                 device: Any = "cuda", **engine_kw):
        from ..models.engine import ContinuousBatchingEngine
        from ..resilience.chaos import serve_monkey_from_spec
        from ..util.chunks import local_machine_id
        from .lora import build_pool

        params, self.device = _to_device(params, device)
        engine_kw.setdefault("prefix_cache", False)
        self.lora_pool = build_pool(config, lora, slots=lora_pool_slots,
                                    rank_max=lora_rank_max,
                                    device=self.device)
        if self.lora_pool is not None:
            engine_kw.setdefault("lora_pool", self.lora_pool)
        self.engine = ContinuousBatchingEngine(params, config,
                                               max_batch=max_batch,
                                               **engine_kw)
        self.server_id = server_id or f"dec-{os.getpid()}-{next(_SERVER_SEQ)}"
        self.machine = local_machine_id()
        self._chaos = serve_monkey_from_spec(chaos, "decode", chaos_replica)
        # the plan's delay_chunk_fetch stretches this replica's KV pulls
        # (the JAX package's fetchers read it from the environment)
        self._chaos_plan = chaos
        self._lock = threading.Lock()
        # open pull handles: handle -> [stream, last activity]; abandoned
        # ones are reaped by idle age
        self._streams: Dict[str, List[Any]] = {}
        self._stats = {k: 0 for k in (
            "transfers", "kv_fetched_bytes", "shm_bytes", "rpc_bytes",
            "chunks_local", "decoded_tokens")}
        # ms of each transfer's fetch, newest last
        self._fetch_ms: List[float] = []
        self._last_push = 0.0
        disagg_metrics()

    # ---------------------------------------------------------- data plane

    def _adopt(self, rec: Dict[str, Any], max_new_tokens: int,
               eos_token: Optional[int], timeout_s: float):
        from ..util import chunks

        if self._chaos is not None:
            self._chaos.on_request()  # may end the process (kill_replica)
        t0 = time.perf_counter()
        desc = rec.get("kv")
        if desc is not None:
            w = _worker()
            if w is None:
                raise RuntimeError(
                    "a chunk-published transfer needs a live cluster "
                    "(ray_tpu_torch.init) on the decode side")
            fetcher = chunks.ChunkFetcher(w, caller="kv",
                                          chaos_plan=self._chaos_plan)
            tree = chunks.fetch_tree(w, desc, fetcher)
            kv_k, kv_v = tree["k"], tree["v"]
            acc = fetcher.stats()
        else:
            kv_k, kv_v = rec["kv_inline"]
            acc = {"chunks_local": 2, "chunks_fetched": 0,
                   "fetched_bytes": 0, "shm_bytes": 0, "rpc_bytes": 0}
        fetch_ms = (time.perf_counter() - t0) * 1e3
        nbytes = int(kv_k.nbytes + kv_v.nbytes)
        # adopt (which checks the layout) before any accounting: a
        # refused adoption leaves no transfer counted
        stream = self.engine.adopt_prefill(
            rec["plen"], rec["first_token"], kv_k, kv_v, max_new_tokens,
            eos_token, score=rec.get("score", 0.0),
            cache_outcome=rec.get("outcome"),
            reused_tokens=rec.get("reused_tokens", 0),
            adapter_id=rec.get("tenant"),
            prompt_tokens=rec.get("prompt_tokens"), timeout_s=timeout_s)
        with self._lock:
            self._stats["transfers"] += 1
            self._stats["kv_fetched_bytes"] += acc["fetched_bytes"]
            for k in ("shm_bytes", "rpc_bytes", "chunks_local"):
                self._stats[k] += acc[k]
            self._fetch_ms.append(fetch_ms)
            del self._fetch_ms[:-256]
        m = disagg_metrics()
        m["transfers"].inc()
        m["kv_bytes"].inc(nbytes, tags={"direction": "recv"})
        _notify_event({"kind": "kv_transfer", "server": self.server_id,
                       "transfer_id": rec.get("transfer_id"),
                       "bytes": nbytes, "plen": rec["plen"],
                       "shm_bytes": acc["shm_bytes"],
                       "rpc_bytes": acc["rpc_bytes"],
                       "outcome": rec.get("outcome")})
        # the request trace: an in-process router's trace is current on
        # this thread (its open kv_transfer phase takes the fetch's
        # breakdown); a decode actor has none and pushes a remote phase
        rt = rec.get("_reqtrace")
        if reqtrace.current_trace() is not None:
            reqtrace.annotate(kv_fetch_ms=round(fetch_ms, 3),
                              kv_bytes=nbytes,
                              shm_bytes=int(acc["shm_bytes"]),
                              rpc_bytes=int(acc["rpc_bytes"]),
                              chunks_local=int(acc["chunks_local"]))
        elif isinstance(rt, dict) and rt.get("request_id"):
            reqtrace.push_remote_phase(
                rt["request_id"], "kv_transfer_remote", fetch_ms,
                attempt=int(rt.get("attempt", 1)),
                server=self.server_id, kv_bytes=nbytes,
                shm_bytes=int(acc["shm_bytes"]),
                rpc_bytes=int(acc["rpc_bytes"]))
        return stream

    def stream_from(self, rec: Dict[str, Any], max_new_tokens: int,
                    eos_token: Optional[int] = None,
                    timeout_s: float = 120.0):
        """Adopt a transfer and return the live token stream (in-process
        callers only)."""
        return _CountedStream(
            self, self._adopt(rec, max_new_tokens, eos_token, timeout_s))

    def decode_from(self, rec: Dict[str, Any], max_new_tokens: int,
                    eos_token: Optional[int] = None,
                    timeout_s: float = 120.0) -> List[int]:
        """Adopt a transfer and decode it to completion; the whole token
        list, first token included."""
        toks = list(self._adopt(rec, max_new_tokens, eos_token, timeout_s))
        self._count_decoded(len(toks))
        return toks

    # chunked pulls: streams cannot cross the actor boundary, and a
    # blocking decode_from loses every produced token when the replica
    # dies; the router pulls in bounded chunks and so always holds the
    # history a failover replays

    def start_decode(self, rec: Dict[str, Any], max_new_tokens: int,
                     eos_token: Optional[int] = None,
                     timeout_s: float = 120.0) -> str:
        """Adopt a transfer and open a pull handle for it."""
        now = time.monotonic()
        stream = self._adopt(rec, max_new_tokens, eos_token, timeout_s)
        hid = f"{self.server_id}-h{next(_SERVER_SEQ)}"
        reaped: List[Any] = []
        with self._lock:
            self._streams[hid] = [stream, now]
            for k, (st, last) in list(self._streams.items()):
                if now - last > self._STREAM_REAP_S:
                    del self._streams[k]  # abandoned by a dead router
                    reaped.append(st)
        for st in reaped:
            self.engine.cancel_slot(st, "idle_reap")
        return hid

    def next_tokens(self, hid: str, max_tokens: int = 64,
                    wait_s: float = 2.0) -> Dict[str, Any]:
        """Up to `max_tokens` from an open handle: waits up to `wait_s`
        for the first, then drains what is there. ``{"tokens": [...],
        "done": bool}``; an empty pull with done False is a keep-alive."""
        from ..models.engine import _DONE

        with self._lock:
            entry = self._streams.get(hid)
            if entry is not None:
                entry[1] = time.monotonic()
        if entry is None:
            raise KeyError(f"unknown decode stream {hid!r} "
                           f"(finished, cancelled, or reaped)")
        req = entry[0]._req
        toks: List[int] = []
        done = False
        try:
            tok = req.out.get(timeout=max(0.0, float(wait_s)))
            while True:
                if tok is _DONE:
                    done = True
                    break
                if isinstance(tok, BaseException):
                    raise RuntimeError("engine decode loop failed") from tok
                toks.append(int(tok))
                if len(toks) >= max(1, int(max_tokens)):
                    break
                tok = req.out.get_nowait()
        except queue.Empty:
            pass
        if toks:
            # counts the tokens and consults chaos: a kill_replica at
            # token:K fires here and this pull's reply is lost
            self._count_decoded(len(toks))
        if done:
            with self._lock:
                self._streams.pop(hid, None)
            self.publish_telemetry()
            return {"tokens": toks, "done": True,
                    "spec_proposed": int(req.spec_proposed),
                    "spec_accepted": int(req.spec_accepted)}
        return {"tokens": toks, "done": done}

    def cancel_decode(self, hid: str, reason: Optional[str] = None) -> bool:
        """Abandon a pull handle: the engine frees the slot at the next
        tick boundary. `reason` tags the engine's cancel count."""
        with self._lock:
            entry = self._streams.pop(hid, None)
        if entry is None:
            return False
        self.engine.cancel_slot(entry[0], reason)
        return True

    def _count_decoded(self, n: int) -> None:
        with self._lock:
            self._stats["decoded_tokens"] += n
        if self._chaos is not None:
            self._chaos.on_tokens(n)  # may end the process (kill_replica)
        self.publish_telemetry()

    # -------------------------------------------------------- control plane

    def capacity(self) -> int:
        return self.engine.max_batch

    def free_slots(self) -> int:
        return self.engine.free_slots

    def prefill_programs(self) -> int:
        """Prefills run in THIS process: 0 on a replica that only
        adopts."""
        from ..models.engine import prefill_paged_calls

        return prefill_paged_calls()

    def describe(self) -> Dict[str, Any]:
        """A router's registration record."""
        return {"server_id": self.server_id, "role": "decode",
                "capacity": self.engine.max_batch, "machine": self.machine,
                "lora": self.lora_pool is not None}

    def prepare_for_shutdown(self, timeout_s: float = 30.0) -> bool:
        """Wait until every slot has finished, then stop the engine;
        whether the drain completed in time."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            drained = self.engine.free_slots == self.engine.max_batch
            if drained or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        self.stop()
        return drained

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
        s.update(role="decode", server_id=self.server_id,
                 capacity=self.engine.max_batch,
                 free_slots=self.engine.free_slots,
                 adopted=self.engine.adopted,
                 cancelled=self.engine.cancelled,
                 prefill_programs=self.prefill_programs())
        if self.engine.speculate_k:
            s["speculation"] = self.engine.speculation_stats()
        if self.lora_pool is not None:
            s["lora"] = self.lora_pool.stats()
        return s

    def fetch_times(self) -> List[float]:
        """ms of each transfer's fetch (descriptor to host tensors)."""
        with self._lock:
            return list(self._fetch_ms)

    def publish_telemetry(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_push < 0.5:
            return
        self._last_push = now
        _push("report_disagg_stats", self.server_id, self.stats())
        if self.lora_pool is not None:
            self.lora_pool.publish_telemetry(force=force)
        # the engine's own kvcache push carries the adoption counters to
        # the kvcache surface
        self.engine.publish_kv_telemetry(force=True)

    def stop(self) -> None:
        self.engine.stop()
        self.publish_telemetry(force=True)


# ----------------------------------------------------------------- router

class _TierReplica:
    """One router-side replica slot; a request holds the object, so the
    set can grow and shrink under it."""

    __slots__ = ("target", "rid", "cap", "inflight", "draining", "machine",
                 "lora")

    def __init__(self, target: Any, rid: str, cap: int,
                 machine: Optional[str] = None, lora: bool = False):
        self.target = target
        self.rid = rid
        self.cap = int(cap)
        self.inflight = 0
        self.draining = False
        self.machine = machine
        self.lora = bool(lora)

    def snapshot(self) -> Dict[str, Any]:
        return {"rid": self.rid, "target": self.target, "cap": self.cap,
                "inflight": self.inflight, "draining": self.draining,
                "machine": self.machine}


# how much prefill work a cache outcome saved, for the recent hit signal
_OUTCOME_WEIGHT = {"hit": 1.0, "partial": 0.5, "miss": 0.0}


class _PreemptSlot:
    """One preemptible (``priority="batch"``) request in flight;
    ``cancel_fn`` is armed while its decode stream is live."""

    __slots__ = ("key", "tenant", "rep", "tokens", "preempted", "cancel_fn")

    def __init__(self, key: int, tenant: Optional[str] = None):
        self.key = key
        self.tenant = tenant
        self.rep: Optional[_TierReplica] = None
        self.tokens = 0
        self.preempted = False
        self.cancel_fn: Optional[Callable[[], None]] = None


class DisaggRouter:
    """Dispatch and admission control over a prefill tier and a decode
    tier, each a sequence of in-process servers or actor handles. With
    no prefill tier it serves through the `colocated` engine, the same
    engine code with the same outputs.

    The replica sets are live (``add_prefill`` / ``add_decode``,
    ``begin_drain``, ``drained``, ``remove``, ``remove_dead``). Decode is
    picked by free slots, prefill by prefix affinity within the subset on
    the decode replica's host (so the KV rides shm), upgraded by the
    prefix directory when ``directory``."""

    def __init__(self, decode: Sequence[Any] = (),
                 prefill: Sequence[Any] = (), *, colocated: Any = None,
                 max_queue_depth: int = QUEUE_DEPTH,
                 retry_after_s: float = RETRY_AFTER_S,
                 affinity_tokens: int = 16,
                 failover_attempts: int = FAILOVER_ATTEMPTS,
                 failover_wait_s: float = 15.0,
                 stream_chunk_tokens: int = 32,
                 directory: bool = True,
                 window_s: float = WINDOW_S,
                 router_id: Optional[str] = None):
        if prefill and not decode:
            raise ValueError(
                "a prefill tier needs a decode tier to stream KV to")
        if not prefill and colocated is None:
            raise ValueError(
                "need a prefill+decode pair or a colocated engine")
        self._colocated = colocated
        self._disagg_mode = bool(prefill)
        self.max_queue_depth = max(0, int(max_queue_depth))
        self.retry_after_s = float(retry_after_s)
        # extra attempts after the first
        self.failover_attempts = max(0, int(failover_attempts))
        # how long a failed-over request waits for a survivor when a tier
        # has no live replica
        self.failover_wait_s = max(0.0, float(failover_wait_s))
        self.stream_chunk_tokens = max(1, int(stream_chunk_tokens))
        self.affinity_tokens = max(1, int(affinity_tokens))
        self.router_id = router_id or \
            f"router-{os.getpid()}-{next(_SERVER_SEQ)}"
        self._lock = threading.Lock()
        self._kvplane_dir = bool(directory)
        # learned from a prefill replica's describe(): directory digests
        # only match at the replicas' block size
        self._kv_block_size: Optional[int] = None
        self._decode: List[_TierReplica] = [
            self._register(d, "decode") for d in decode]
        self._prefill: List[_TierReplica] = [
            self._register(p, "prefill") for p in prefill]
        if not self._decode:
            self._decode = [_TierReplica(
                colocated, f"{self.router_id}-colocated",
                int(colocated.max_batch))]
        self._push_retention_hint()
        self._ttft_win = SlidingWindow(window_s)
        self._depth_win = SlidingWindow(window_s)
        self._pf_inflight_win = SlidingWindow(window_s)
        self._cache_win = SlidingWindow(window_s)
        self._pf_inflight = 0
        self._stats = {k: 0 for k in (
            "dispatched", "completed", "shed", "max_pending",
            "shm_affinity_hits", "shm_affinity_total",
            "tenant_affinity_hits", "tenant_affinity_total",
            "tier_wakeups", "preemptions", "preempted_requests",
            "directory_hits", "directory_misses", "directory_fallbacks")}
        self._preempt_seq = itertools.count()
        self._preempt_reg: Dict[int, _PreemptSlot] = {}
        self._tier_waker: Optional[Callable[[str], bool]] = None
        # per-tenant isolation, LRU-capped
        self._tenant_stats: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._tenant_decode: "OrderedDict[str, str]" = OrderedDict()
        self._tenant_cap = 512
        self._tenant_slo_ms = TARGET_P99_MS
        self._sf = {"failovers": {"prefill": 0, "decode": 0},
                    "failover_requests": 0, "sheds_by_cause": {},
                    "removed_dead": {"prefill": 0, "decode": 0}}
        # ms from a failure's detection to the replayed prefill landing
        self._failover_win = SlidingWindow()
        self._last_push = 0.0
        self._last_sf_push = 0.0
        disagg_metrics()
        servefault_metrics()

    # ----------------------------------------------------- replica set ops

    def _register(self, target: Any, tier: str) -> _TierReplica:
        try:
            info = _call(target, "describe")
        except Exception:  # noqa: BLE001 — a replica without describe()
            info = {}
        rid = info.get("server_id") or \
            f"{tier}-{self.router_id}-{next(_SERVER_SEQ)}"
        cap = int(info.get("capacity")
                  or (_call(target, "capacity") if tier == "decode" else 0))
        if tier == "prefill" and self._kv_block_size is None:
            bs = info.get("kv_block_size")
            if bs:
                self._kv_block_size = int(bs)
        return _TierReplica(target, rid, cap, info.get("machine"),
                            bool(info.get("lora")))

    def _push_retention_hint(self) -> None:
        """Every admissible request may be in flight at once, all on one
        prefill server: push that bound to the servers' retention."""
        with self._lock:
            prefill = list(self._prefill)
            hint = 2 * sum(r.cap + self.max_queue_depth
                           for r in self._decode)
        for pf in prefill:
            try:
                _call(pf.target, "set_retention", hint, block=False)
            except Exception:  # noqa: BLE001 — replica mid-restart
                pass

    def add_decode(self, target: Any) -> str:
        """Admit a decode replica: dispatchable when this returns."""
        rep = self._register(target, "decode")
        with self._lock:
            self._decode.append(rep)
        self._push_retention_hint()
        self.publish_telemetry(force=True)
        return rep.rid

    def add_prefill(self, target: Any) -> str:
        """Admit a prefill replica (affinity re-hashes over the set)."""
        rep = self._register(target, "prefill")
        with self._lock:
            self._prefill.append(rep)
        self._push_retention_hint()
        self.publish_telemetry(force=True)
        return rep.rid

    def set_tier_waker(self, fn: Optional[Callable[[str], bool]]) -> None:
        """The scale-from-zero hook: `fn(tier)` is called when a request
        finds that tier empty and returns whether a replica is coming
        (the arrival then waits for it). Must not block."""
        self._tier_waker = fn

    def _wake_tier(self, tier: str) -> bool:
        waker = self._tier_waker
        if waker is None:
            return False
        try:
            woke = bool(waker(tier))
        except Exception:  # noqa: BLE001 — treat as no wake coming
            return False
        if woke:
            with self._lock:
                self._stats["tier_wakeups"] += 1
            _notify_event({"kind": "tier_wake", "router": self.router_id,
                           "tier": tier})
        return woke

    def _lora_enabled(self) -> bool:
        """Whether this deployment serves tenant-tagged requests: a tier
        replica advertised an adapter pool (describe()'s `lora`), or the
        colocated engine holds one. The gateway hands a tenant to the
        data plane only then."""
        if self._colocated is not None and \
                getattr(self._colocated, "lora_pool", None) is not None:
            return True
        with self._lock:
            return any(r.lora for r in self._prefill + self._decode)

    def _tier(self, tier: str) -> List[_TierReplica]:
        if tier not in ("prefill", "decode"):
            raise ValueError(f"unknown tier {tier!r}")
        return self._prefill if tier == "prefill" else self._decode

    def tier_replicas(self, tier: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.snapshot() for r in self._tier(tier)]

    def begin_drain(self, tier: str, rid: str, *,
                    allow_empty: bool = False) -> bool:
        """Stop dispatching to one replica (its requests finish). The
        last active replica of a tier is refused unless ``allow_empty``
        and a tier waker is attached."""
        with self._lock:
            reps = self._tier(tier)
            active = [r for r in reps if not r.draining]
            for r in reps:
                if r.rid == rid and not r.draining:
                    if len(active) <= 1 and not (
                            allow_empty and self._tier_waker is not None):
                        return False
                    r.draining = True
                    break
            else:
                return False
        self.publish_telemetry(force=True)
        return True

    def drained(self, tier: str, rid: str) -> bool:
        """True when a draining replica has nothing in flight."""
        with self._lock:
            for r in self._tier(tier):
                if r.rid == rid:
                    return r.draining and r.inflight == 0
        return True  # already removed

    def remove(self, tier: str, rid: str) -> Optional[Any]:
        """Retire a draining replica; returns its target."""
        with self._lock:
            reps = self._tier(tier)
            for i, r in enumerate(reps):
                if r.rid == rid:
                    if not r.draining:
                        raise ValueError(
                            f"{tier} replica {rid} is not draining — "
                            "begin_drain() first so dispatch stops "
                            "before the replica disappears")
                    del reps[i]
                    return r.target
        return None

    def remove_dead(self, tier: str, rid: str) -> bool:
        """Remove a dead replica at once (no drain). Idempotent."""
        with self._lock:
            reps = self._tier(tier)
            for i, r in enumerate(reps):
                if r.rid == rid:
                    del reps[i]
                    self._sf["removed_dead"][tier] += 1
                    break
            else:
                return False
        self.publish_telemetry(force=True)
        self.publish_servefault(force=True)
        return True

    # ------------------------------------------------------- failover core

    def _tier_call(self, rep: _TierReplica, tier: str, method: str, *args,
                   block: bool = True, **kw):
        """The supervised data-plane call: a death-shaped failure removes
        the corpse and raises ReplicaDeadError."""
        try:
            return _call(rep.target, method, *args, block=block, **kw)
        except _DEATH_TYPES as e:
            self.remove_dead(tier, rep.rid)
            raise ReplicaDeadError(tier, rep.rid, e) from e

    def _count_failover(self, phase: str, rid: str, attempt: int,
                        detail: str) -> None:
        with self._lock:
            self._sf["failovers"][phase] += 1
        servefault_metrics()["failovers"].inc(tags={"phase": phase})
        _notify("report_resilience_event",
                {"kind": "failover", "phase": phase,
                 "router": self.router_id, "replica": rid,
                 "attempt": attempt, "detail": detail[:200]})
        self.publish_servefault()

    def _tenant_rec_locked(self, tenant: str) -> Dict[str, Any]:
        rec = self._tenant_stats.get(tenant)
        if rec is None:
            rec = {"dispatched": 0, "completed": 0, "shed": 0,
                   "sheds_by_cause": {}, "slo_misses": 0,
                   "ttft": SlidingWindow(), "latency": SlidingWindow()}
            self._tenant_stats[tenant] = rec
            while len(self._tenant_stats) > self._tenant_cap:
                self._tenant_stats.popitem(last=False)
        self._tenant_stats.move_to_end(tenant)
        return rec

    def _shed(self, cause: str, message: str,
              tenant: Optional[str] = None) -> RequestShedError:
        """Count an attributed shed and build its error (the caller
        raises it)."""
        with self._lock:
            self._stats["shed"] += 1
            by = self._sf["sheds_by_cause"]
            by[cause] = by.get(cause, 0) + 1
            if tenant is not None:
                trec = self._tenant_rec_locked(tenant)
                trec["shed"] += 1
                tby = trec["sheds_by_cause"]
                tby[cause] = tby.get(cause, 0) + 1
        shed_counter().inc(tags={"app": "disagg",
                                 "deployment": self.router_id})
        servefault_metrics()["sheds"].inc(tags={"cause": cause})
        _notify_event({"kind": "shed", "router": self.router_id,
                       "cause": cause, "retry_after_s": self.retry_after_s})
        self.publish_telemetry()
        self.publish_servefault()
        return RequestShedError(message, retry_after_s=self.retry_after_s,
                                cause=cause)

    # ------------------------------------------------------------ admission

    def _admit_or_shed(self, tenant: Optional[str] = None,
                       deadline: Optional[float] = None,
                       priority: Optional[str] = None) -> _TierReplica:
        """Reserve a decode replica or shed: shed when every active
        replica's in-flight count has reached capacity +
        max_queue_depth. Check and reservation under one lock hold. A
        tenant prefers the replica that served it last; an interactive
        arrival that finds every replica full preempts the cheapest
        batch stream and rides its slot."""
        affinity_hit = False
        wake_until: Optional[float] = None
        while True:
            victim: Optional[_PreemptSlot] = None
            with self._lock:
                open_reps = [r for r in self._decode if not r.draining
                             and r.inflight < r.cap + self.max_queue_depth]
                pending = sum(r.inflight for r in self._decode)
                if not open_reps and priority == "interactive":
                    victim = self._pick_victim_locked()
                    if victim is not None:
                        rep = victim.rep
                        rep.inflight += 1
                        pending += 1
                        self._stats["dispatched"] += 1
                        self._stats["preemptions"] += 1
                        self._stats["max_pending"] = max(
                            self._stats["max_pending"], pending)
                        if tenant is not None:
                            self._tenant_rec_locked(
                                tenant)["dispatched"] += 1
                if open_reps:
                    rep = min(open_reps, key=lambda r: r.inflight)
                    if tenant is not None:
                        self._stats["tenant_affinity_total"] += 1
                        want = self._tenant_decode.get(tenant)
                        for r in open_reps:
                            if r.rid == want:
                                rep = r
                                affinity_hit = True
                                self._stats["tenant_affinity_hits"] += 1
                                break
                        self._tenant_rec_locked(tenant)["dispatched"] += 1
                    rep.inflight += 1
                    pending += 1
                    self._stats["dispatched"] += 1
                    self._stats["max_pending"] = max(
                        self._stats["max_pending"], pending)
                tier_empty = not any(not r.draining for r in self._decode)
            if victim is not None:
                self._fire_preemption(victim)
                self._depth_win.add(pending)
                break
            if open_reps:
                self._depth_win.add(pending)
                break
            if tier_empty and self._tier_waker is not None:
                if wake_until is None and self._wake_tier("decode"):
                    wake_until = time.monotonic() + self.failover_wait_s
                if wake_until is not None and time.monotonic() < wake_until:
                    self._check_deadline(deadline, tenant)
                    time.sleep(0.1)
                    continue
            self._depth_win.add(pending)
            raise self._shed(
                "capacity",
                f"disagg router {self.router_id}: every decode replica is "
                f"at capacity + queue depth {self.max_queue_depth} "
                f"(pending {pending}); retry after "
                f"{self.retry_after_s:.1f}s", tenant)
        if self._prefill and len(open_reps) > 1 and not affinity_hit:
            # refine by live free slots: all probes issued before any is
            # awaited; ties go to the last candidate
            try:
                import ray_tpu_torch as rt
                from .._private.object_store import ObjectRef

                probes = [(r, _call(r.target, "free_slots", block=False))
                          for r in open_reps]
                frees = [(min(int(rt.get(v) if isinstance(v, ObjectRef)
                                  else v), r.cap - r.inflight), i)
                         for i, (r, v) in enumerate(probes)]
                best = probes[max(frees)[1]][0]
            except Exception:  # noqa: BLE001 — replica mid-restart
                best = rep
            if best is not rep:
                with self._lock:
                    if not best.draining and best.inflight < \
                            best.cap + self.max_queue_depth:
                        rep.inflight -= 1
                        best.inflight += 1
                        rep = best
        if tenant is not None:
            self._note_tenant_decode(tenant, rep.rid)
        disagg_metrics()["queue_depth"].set(pending,
                                            tags={"router": self.router_id})
        self.publish_telemetry()
        return rep

    # ----------------------------------------------------- qos preemption

    def _preempt_register(self, priority: Optional[str],
                          tenant: Optional[str]) -> Optional[_PreemptSlot]:
        if priority != "batch":
            return None
        slot = _PreemptSlot(next(self._preempt_seq), tenant)
        with self._lock:
            self._preempt_reg[slot.key] = slot
        return slot

    def _preempt_unregister(self, slot: Optional[_PreemptSlot]) -> None:
        if slot is None:
            return
        with self._lock:
            self._preempt_reg.pop(slot.key, None)

    def _pick_victim_locked(self) -> Optional[_PreemptSlot]:
        """The live batch stream with the fewest delivered tokens (the
        cheapest replay), marked preempted here (exactly once)."""
        cands = [s for s in self._preempt_reg.values()
                 if s.cancel_fn is not None and s.rep is not None
                 and not s.preempted]
        if not cands:
            return None
        victim = min(cands, key=lambda s: s.tokens)
        victim.preempted = True
        return victim

    def _fire_preemption(self, victim: _PreemptSlot) -> None:
        """Cancel the victim's live stream (tagged ``preempt`` in the
        engine) and count the preemption into the gateway's surface. The
        victim's loop sees its stream end early and replays; its
        reservation never moves."""
        fn = victim.cancel_fn
        if fn is not None:
            try:
                fn()
            except Exception:  # noqa: BLE001 — victim mid-teardown
                pass
        try:
            from .qos import gateway_metrics, push_gateway_event

            gateway_metrics()["preemptions"].inc()
            push_gateway_event({"kind": "preempt",
                                "router": self.router_id,
                                "victim_tenant": victim.tenant,
                                "tokens_done": victim.tokens})
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        _notify_event({"kind": "preempt", "router": self.router_id,
                       "victim_tenant": victim.tenant})
        self.publish_telemetry()

    def _note_tenant_decode(self, tenant: str, rid: str) -> None:
        with self._lock:
            self._tenant_decode[tenant] = rid
            self._tenant_decode.move_to_end(tenant)
            while len(self._tenant_decode) > self._tenant_cap:
                self._tenant_decode.popitem(last=False)

    def _complete(self, rep: _TierReplica, ok: bool = True, *,
                  tenant: Optional[str] = None,
                  wall_ms: Optional[float] = None) -> None:
        """Release a reservation; `completed` counts only requests that
        returned tokens."""
        with self._lock:
            if rep.inflight > 0:
                rep.inflight -= 1
            if ok:
                self._stats["completed"] += 1
                if tenant is not None:
                    trec = self._tenant_rec_locked(tenant)
                    trec["completed"] += 1
                    if wall_ms is not None:
                        trec["latency"].add(wall_ms)
            pending = sum(r.inflight for r in self._decode)
        disagg_metrics()["queue_depth"].set(pending,
                                            tags={"router": self.router_id})
        self.publish_telemetry()

    # ------------------------------------------------------------- dispatch

    def _directory_entry(self, prompt: np.ndarray, tenant: Optional[str]
                         ) -> Optional[Dict[str, Any]]:
        """The directory's entry for this prompt's longest published
        prefix: None when the lookup was not attempted (directory off, no
        cluster, block size unknown, a tenant request, whose namespace
        holds the adapter version only the replica knows), {} when it
        found nothing."""
        if not self._kvplane_dir or tenant is not None:
            return None
        bs = self._kv_block_size
        w = _worker()
        if bs is None or w is None:
            return None
        try:
            entry = kvp.directory_lookup(w, None, [int(t) for t in prompt],
                                         bs)
        except Exception:  # noqa: BLE001 — conductor unreachable
            return None
        return entry if entry is not None else {}

    def _pick_prefill(self, prompt: np.ndarray,
                      decode_machine: Optional[str],
                      tenant: Optional[str] = None
                      ) -> Tuple[_TierReplica, Optional[Dict[str, Any]]]:
        """Prefix affinity within the replicas on the decode replica's
        host: a stable hash of (tenant, the prompt's first
        affinity_tokens). The directory upgrades it: a live holder wins;
        a holder gone from the set degrades to the hash plus a tier-3
        hint. Returns (replica, hint)."""
        dir_entry = self._directory_entry(prompt, tenant)
        head = (tenant,) + tuple(int(t) for t in prompt[:self.affinity_tokens])
        hint: Optional[Dict[str, Any]] = None
        outcome: Optional[str] = None
        with self._lock:
            cands = [r for r in self._prefill if not r.draining]
            if not cands:  # every prefill draining: keep serving
                cands = list(self._prefill)
            if not cands:  # every prefill dead: the caller waits or sheds
                raise LookupError("no live prefill replica")
            rep = None
            if dir_entry:
                by_rid = {r.rid: r for r in cands}
                holder = dir_entry.get("holder")
                if holder in by_rid:
                    rep = by_rid[holder]
                    outcome = "hit"
                    self._stats["directory_hits"] += 1
                else:
                    hint = dir_entry
                    outcome = "fallback"
                    self._stats["directory_fallbacks"] += 1
            elif dir_entry is not None:
                outcome = "miss"
                self._stats["directory_misses"] += 1
            if rep is None:
                local = [r for r in cands if decode_machine is not None
                         and r.machine == decode_machine]
                pool = local or cands
                rep = pool[hash(head) % len(pool)]
            self._stats["shm_affinity_total"] += 1
            if decode_machine is not None and rep.machine == decode_machine:
                self._stats["shm_affinity_hits"] += 1
        if outcome is not None:
            kvp.kvplane_metrics()["directory"].inc(tags={"outcome": outcome})
            if outcome == "hit":
                _notify_kvplane({"kind": "directory_hit",
                                 "router": self.router_id,
                                 "replica": rep.rid,
                                 "digest": dir_entry.get("digest"),
                                 "blocks": dir_entry.get("blocks")})
        return rep, hint

    def _check_deadline(self, deadline: Optional[float],
                        tenant: Optional[str] = None) -> None:
        if deadline is not None and time.perf_counter() > deadline:
            raise self._shed(
                "deadline",
                f"disagg router {self.router_id}: request outlived its "
                f"deadline; retry after {self.retry_after_s:.1f}s", tenant)

    def _check_abort(self, deadline: Optional[float],
                     tenant: Optional[str] = None,
                     cancel_event: Any = None) -> None:
        """`_check_deadline` plus the gateway's client-gone signal: a set
        `cancel_event` sheds with cause ``disconnect``, so an abandoned
        decode stops taking ticks for a socket nobody reads."""
        self._check_deadline(deadline, tenant)
        if cancel_event is not None and cancel_event.is_set():
            raise self._shed(
                "disconnect",
                f"disagg router {self.router_id}: client disconnected "
                f"mid-request; decode cancelled", tenant)

    def _ack_transfer(self, pf: _TierReplica, rec: Dict[str, Any]) -> None:
        """Release the sender's chunk refs (the sender may be dead: then
        its refs died with it)."""
        try:
            _call(pf.target, "ack", rec["transfer_id"], block=False)
        except Exception:  # noqa: BLE001 — replica already dead
            pass

    def _shed_pool_exhausted(self, phase: str, tenant: Optional[str],
                             e: BaseException) -> RequestShedError:
        return self._shed(
            "capacity",
            f"disagg router {self.router_id}: {phase} adapter pool "
            f"exhausted (every row pinned); retry after "
            f"{self.retry_after_s:.1f}s", tenant)

    def _check_request_fault(self, tenant: Optional[str],
                             e: BaseException) -> None:
        """A tenant's configuration error reaches the caller; anything
        else uses up a failover attempt."""
        if _is_lora_config_error(e):
            raise ValueError(
                f"tenant {tenant!r} is misconfigured for this "
                f"deployment: {str(e)[:240]}") from e

    def _attempt_failed(self, phase: str, rid: str, attempt: int,
                        err: BaseException,
                        tenant: Optional[str] = None) -> None:
        """Count one failed attempt; shed with cause ``failover`` once
        the budget is spent."""
        self._count_failover(phase, rid, attempt,
                             f"{type(err).__name__}: {err}")
        if attempt > self.failover_attempts:
            raise self._shed(
                "failover",
                f"disagg router {self.router_id}: {phase} failure on "
                f"attempt {attempt}/{1 + self.failover_attempts} "
                f"({type(err).__name__}: {str(err)[:160]}); failover "
                f"budget exhausted", tenant) from err

    def _pick_prefill_or_wait(self, prompt: np.ndarray,
                              decode_machine: Optional[str],
                              deadline: Optional[float],
                              tenant: Optional[str] = None
                              ) -> Tuple[_TierReplica,
                                         Optional[Dict[str, Any]]]:
        """_pick_prefill, waiting out an empty prefill tier up to
        ``failover_wait_s`` before shedding with cause failover."""
        wait_until = time.monotonic() + self.failover_wait_s
        woke = False
        while True:
            try:
                return self._pick_prefill(prompt, decode_machine, tenant)
            except LookupError:
                if not woke:
                    self._wake_tier("prefill")
                    woke = True
            self._check_deadline(deadline, tenant)
            if time.monotonic() >= wait_until:
                raise self._shed(
                    "failover",
                    f"disagg router {self.router_id}: no live prefill "
                    f"replica after {self.failover_wait_s:.0f}s", tenant)
            time.sleep(0.25)

    def _reserve_survivor(self, old: _TierReplica,
                          deadline: Optional[float],
                          tenant: Optional[str] = None) -> _TierReplica:
        """Move an accepted request's reservation off a failed decode
        replica onto the least loaded survivor (no admission check: the
        request was accepted), waiting out an empty tier."""
        wait_until = time.monotonic() + self.failover_wait_s
        while True:
            with self._lock:
                cands = [r for r in self._decode if not r.draining]
                if cands:
                    rep = min(cands, key=lambda r: r.inflight)
                    rep.inflight += 1
                    if old.inflight > 0:
                        old.inflight -= 1
                else:
                    rep = None
            if rep is not None:
                if tenant is not None:
                    self._note_tenant_decode(tenant, rep.rid)
                return rep
            self._check_deadline(deadline, tenant)
            if time.monotonic() >= wait_until:
                raise self._shed(
                    "failover",
                    f"disagg router {self.router_id}: no live decode "
                    f"replica after {self.failover_wait_s:.0f}s", tenant)
            time.sleep(0.25)

    def generate(self, prompt_tokens, max_new_tokens: int,
                 eos_token: Optional[int] = None, *,
                 timeout_s: float = 120.0,
                 deadline_s: Optional[float] = None,
                 on_first_token=None, token_sleep_s: float = 0.0,
                 tenant: Optional[str] = None,
                 priority: Optional[str] = None,
                 on_tokens=None, cancel_event: Any = None) -> List[int]:
        """One request end to end; its tokens. `on_first_token()` fires
        when the first token exists (at the prefill's end under
        disaggregation). `token_sleep_s` paces a slow client;
        `deadline_s` bounds the request's wall time (past it: shed with
        cause ``deadline``). `tenant`: serve under that tenant's adapter.
        `priority` ``"batch"`` may be preempted, ``"interactive"`` may
        preempt; `on_tokens(list)` gets each delivered chunk.
        `cancel_event` (a threading.Event; the gateway sets it when the
        HTTP client goes away) sheds the request with cause
        ``disconnect`` once set. Once
        admitted, the request returns every token, bit-identical to an
        uninterrupted greedy run, or raises a RequestShedError with a
        cause."""
        if priority is not None and priority not in ("interactive", "batch"):
            raise ValueError(f"unknown priority class {priority!r}; "
                             f"expected 'interactive' or 'batch'")
        if tenant is None and self._lora_enabled():
            # a LoRA deployment's default tenant is the serve request's
            # multiplexed model id; a pool-less router keeps serving
            # multiplexed requests as before
            from .multiplex import request_tenant

            tenant = request_tenant()
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        deadline = (None if deadline_s is None
                    else time.perf_counter() + float(deadline_s))
        # the request trace: a caller's trace current on this thread is
        # taken over (the caller finishes it); otherwise the router mints
        # and finishes its own. Either way every hop below stamps phases
        # on the thread's current trace.
        tr = reqtrace.current_trace()
        owned = tr is None
        if owned:
            tr = reqtrace.start_trace(source="router", tenant=tenant,
                                      cls=priority)
        try:
            with reqtrace.activate(tr):
                self._check_deadline(deadline, tenant)  # arrived expired
                # rep_box[0]: the decode replica holding the reservation
                # now (failover moves it; the release must hit the
                # current one)
                with reqtrace.phase("queue_reserve"):
                    rep_box = [self._admit_or_shed(tenant, deadline,
                                                   priority)]
                t_admit = time.perf_counter()
                pslot = self._preempt_register(priority, tenant)
                ok = False
                try:
                    if not self._disagg_mode:
                        out = self._generate_colocated(
                            prompt, max_new_tokens, eos_token, timeout_s,
                            deadline, on_first_token, token_sleep_s,
                            t_admit, tenant, pslot, on_tokens, cancel_event,
                            rep_box)
                    else:
                        out = self._generate_disagg(
                            rep_box, prompt, max_new_tokens, eos_token,
                            timeout_s, deadline, on_first_token,
                            token_sleep_s, t_admit, tenant, pslot,
                            on_tokens, cancel_event)
                    ok = True
                    if owned and tr is not None:
                        tr.finish("ok", tokens=len(out))
                    return out
                finally:
                    self._preempt_unregister(pslot)
                    self._complete(rep_box[0], ok, tenant=tenant,
                                   wall_ms=(time.perf_counter() - t_admit)
                                   * 1e3)
        except RequestShedError as e:
            if owned and tr is not None:
                cause = getattr(e, "cause", None)
                outcome = {"deadline": "deadline",
                           "disconnect": "disconnect",
                           "preempt": "preempt"}.get(cause, "shed")
                tr.finish(outcome, cause=cause)
            raise
        except BaseException as e:
            if owned and tr is not None:
                tr.finish("error", cause=type(e).__name__)
            raise

    def _record_tenant_ttft(self, tenant: Optional[str],
                            ttft_ms: float) -> None:
        if tenant is None:
            return
        with self._lock:
            rec = self._tenant_rec_locked(tenant)
            rec["ttft"].add(ttft_ms)
            if ttft_ms > self._tenant_slo_ms:
                rec["slo_misses"] += 1

    def _first_token(self, t_admit: float, tenant: Optional[str],
                     on_first_token, outcome: Optional[str] = None) -> None:
        ttft = (time.perf_counter() - t_admit) * 1e3
        self._ttft_win.add(ttft)
        self._record_tenant_ttft(tenant, ttft)
        if outcome is not None:
            self._cache_win.add(_OUTCOME_WEIGHT.get(outcome, 0.0))
        if on_first_token is not None:
            on_first_token()

    @staticmethod
    def _finished(history: List[int], max_new_tokens: int,
                  eos_token: Optional[int]) -> bool:
        return len(history) >= max_new_tokens or (
            eos_token is not None and bool(history)
            and history[-1] == int(eos_token))

    def _generate_colocated(self, prompt, max_new_tokens, eos_token,
                            timeout_s, deadline, on_first_token,
                            token_sleep_s, t_admit, tenant=None, pslot=None,
                            on_tokens=None, cancel_event=None,
                            rep_box=None) -> List[int]:
        """The single-engine path, a replay loop as the disaggregated
        one: a preempted batch stream resumes from prompt + history."""
        history: List[int] = []
        first_emitted = False
        had_preempt = False
        tr = reqtrace.current_trace()
        while not self._finished(history, max_new_tokens, eos_token):
            replay = (np.concatenate([prompt, np.asarray(history, np.int64)])
                      if history else prompt)
            try:
                stream = self._colocated.stream(
                    replay, max_new_tokens - len(history), eos_token,
                    timeout_s=timeout_s, adapter_id=tenant)
            except Exception as e:  # noqa: BLE001 — submit-time failure
                if _is_pool_exhausted(e):
                    raise self._shed_pool_exhausted("colocated", tenant,
                                                    e) from e
                raise
            if pslot is not None:
                with self._lock:
                    pslot.rep = rep_box[0] if rep_box else None
                    pslot.cancel_fn = (
                        lambda s=stream: self._colocated.cancel_slot(
                            s, "preempt"))
            t_dec = time.perf_counter()
            t_first_tok: Optional[float] = None
            n_attempt_toks = 0
            try:
                for tok in stream:
                    if t_first_tok is None:
                        t_first_tok = time.perf_counter()
                        if tr is not None:
                            tr.add_phase("decode_first_token",
                                         (t_first_tok - t_dec) * 1e3)
                    n_attempt_toks += 1
                    if not first_emitted:
                        first_emitted = True
                        self._first_token(t_admit, tenant, on_first_token)
                    history.append(tok)
                    if pslot is not None:
                        pslot.tokens = len(history)
                    if on_tokens is not None:
                        try:
                            on_tokens([tok])
                        except Exception:  # noqa: BLE001 — the caller's
                            pass
                    if token_sleep_s > 0:
                        time.sleep(token_sleep_s)
                    self._check_abort(deadline, tenant, cancel_event)
            except RequestShedError as e:
                # shed mid-stream (deadline, disconnect): the engine frees
                # the slot at its tick boundary, counted under the cause
                if tr is not None:
                    tr.add_phase(
                        "decode_steady" if t_first_tok is not None
                        else "decode_first_token",
                        (time.perf_counter() - (t_first_tok or t_dec))
                        * 1e3, tokens=n_attempt_toks,
                        error=getattr(e, "cause", None) or "shed")
                cancel = getattr(self._colocated, "cancel_slot", None)
                if callable(cancel):
                    cancel(stream, getattr(e, "cause", None))
                raise
            finally:
                if pslot is not None:
                    with self._lock:
                        pslot.cancel_fn = None
            if tr is not None and t_first_tok is not None:
                tr.add_phase("decode_steady",
                             (time.perf_counter() - t_first_tok) * 1e3,
                             tokens=n_attempt_toks)
            if pslot is not None and pslot.preempted \
                    and not self._finished(history, max_new_tokens,
                                           eos_token):
                # an interactive request took the slot: resume
                with self._lock:
                    pslot.preempted = False
                had_preempt = True
                if tr is not None:
                    tr.mark_preempt()
                time.sleep(0.1)  # let the preemptor land
                continue
            break
        if had_preempt:
            with self._lock:
                self._stats["preempted_requests"] += 1
        return history

    def _generate_disagg(self, rep_box, prompt, max_new_tokens, eos_token,
                         timeout_s, deadline, on_first_token, token_sleep_s,
                         t_admit, tenant=None, pslot=None,
                         on_tokens=None, cancel_event=None) -> List[int]:
        """The failover loop: `history` holds every delivered token; a
        replay prefills prompt + history and decodes the rest on a
        survivor. A preemption rides the same loop without using an
        attempt or moving the reservation."""
        history: List[int] = []
        attempt = 0
        first_emitted = False
        fail_detected: Optional[float] = None
        had_failover = False
        had_preempt = False
        tr = reqtrace.current_trace()

        def preempt_resume() -> bool:
            """True once per fired preemption whose stream ended early."""
            nonlocal had_preempt
            if pslot is None or not pslot.preempted:
                return False
            if self._finished(history, max_new_tokens, eos_token):
                return False
            with self._lock:
                pslot.preempted = False
            had_preempt = True
            if tr is not None:
                # the replay's phases carry the new attempt number
                tr.mark_preempt()
            time.sleep(0.1)  # let the preemptor land
            return True

        while True:
            rep = rep_box[0]
            attempt += 1
            self._check_abort(deadline, tenant, cancel_event)
            if self._finished(history, max_new_tokens, eos_token):
                # the replica died between the last token and DONE
                return history
            replay = (np.concatenate([prompt, np.asarray(history, np.int64)])
                      if history else prompt)
            # ---- prefill (retryable: nothing emitted from rec yet)
            pf, kv_hint = self._pick_prefill_or_wait(replay, rep.machine,
                                                     deadline, tenant)
            with self._lock:
                self._pf_inflight += 1
                pf.inflight += 1
            self._pf_inflight_win.add(self._pf_inflight)
            try:
                pf_args = (replay.tolist(), tenant) if kv_hint is None \
                    else (replay.tolist(), tenant, kv_hint)
                with reqtrace.phase("prefill", replica=pf.rid,
                                    prompt_tokens=int(replay.size)):
                    rec = self._tier_call(pf, "prefill", "prefill",
                                          *pf_args)
            except Exception as e:  # noqa: BLE001 — dead or broken
                if _is_pool_exhausted(e):
                    raise self._shed_pool_exhausted("prefill", tenant,
                                                    e) from e
                self._check_request_fault(tenant, e)
                fail_detected = time.perf_counter()
                had_failover = True
                self._attempt_failed("prefill", pf.rid, attempt, e, tenant)
                if tr is not None:
                    tr.begin_attempt()
                continue
            finally:
                with self._lock:
                    self._pf_inflight -= 1
                    if pf.inflight > 0:
                        pf.inflight -= 1
            try:
                if tr is not None and rec.get("kvplane"):
                    # the KV plane's fetches inside the prefill, as
                    # phases of their own
                    for tier_n, ph in (("tier2", "kvplane_tier2_fetch"),
                                       ("tier3", "kvplane_tier3_fetch")):
                        tinfo = rec["kvplane"].get(tier_n)
                        if tinfo:
                            tr.add_phase(
                                ph, float(tinfo.get("ms", 0.0)),
                                replica=pf.rid,
                                blocks=int(tinfo.get("blocks", 0)),
                                tokens=int(tinfo.get("tokens", 0)),
                                kv_bytes=int(tinfo.get("nbytes", 0)))
                if not first_emitted:
                    first_emitted = True
                    self._first_token(t_admit, tenant, on_first_token,
                                      rec.get("outcome"))
                if fail_detected is not None:
                    self._failover_win.add(
                        (time.perf_counter() - fail_detected) * 1e3)
                    fail_detected = None
            except BaseException:
                # a raising callback must not strand the transfer unacked
                self._ack_transfer(pf, rec)
                raise
            # ---- decode: chunked pulls, so the router holds the history
            hid = None
            chunk = self.stream_chunk_tokens
            if token_sleep_s > 0:
                # keep the gap between pulls inside the idle reap
                chunk = max(1, min(chunk, int(120.0 / token_sleep_s) or 1))
            t_dec: Optional[float] = None
            t_first_tok: Optional[float] = None
            n_attempt_toks = 0
            try:
                if tr is not None:
                    # a decode actor pushes its fetch as a remote phase
                    # under this id; an in-process one annotates the open
                    # kv_transfer phase
                    rec["_reqtrace"] = {"request_id": tr.request_id,
                                        "attempt": attempt}
                with reqtrace.phase("kv_transfer", replica=rep.rid):
                    hid = self._tier_call(rep, "decode", "start_decode",
                                          rec, max_new_tokens - len(history),
                                          eos_token, timeout_s)
                t_dec = time.perf_counter()
                if pslot is not None:
                    with self._lock:
                        pslot.rep = rep
                        pslot.cancel_fn = (
                            lambda r=rep, h=hid: _call(
                                r.target, "cancel_decode", h, "preempt",
                                block=False))
                last_progress = time.perf_counter()
                while True:
                    out = self._tier_call(rep, "decode", "next_tokens", hid,
                                          chunk,
                                          min(2.0, max(0.1, timeout_s / 4)))
                    toks = out.get("tokens") or []
                    if toks:
                        if t_first_tok is None:
                            t_first_tok = time.perf_counter()
                            if tr is not None:
                                tr.add_phase("decode_first_token",
                                             (t_first_tok - t_dec) * 1e3,
                                             replica=rep.rid)
                        n_attempt_toks += len(toks)
                        history.extend(int(t) for t in toks)
                        if pslot is not None:
                            pslot.tokens = len(history)
                        if on_tokens is not None:
                            try:
                                on_tokens([int(t) for t in toks])
                            except Exception:  # noqa: BLE001 — the caller's
                                pass
                        last_progress = time.perf_counter()
                        if token_sleep_s > 0:
                            time.sleep(token_sleep_s * len(toks))
                    if out.get("done"):
                        if tr is not None:
                            spec_attrs = {k: int(out[k]) for k in (
                                "spec_proposed", "spec_accepted")
                                if out.get(k) is not None}
                            tr.add_phase(
                                "decode_steady",
                                (time.perf_counter()
                                 - (t_first_tok or t_dec)) * 1e3,
                                replica=rep.rid, tokens=n_attempt_toks,
                                **spec_attrs)
                        self._ack_transfer(pf, rec)
                        if preempt_resume():
                            break  # the cancelled slot drained: replay
                        if had_failover:
                            with self._lock:
                                self._sf["failover_requests"] += 1
                            self.publish_servefault()
                        if had_preempt:
                            with self._lock:
                                self._stats["preempted_requests"] += 1
                        return history
                    try:
                        self._check_abort(deadline, tenant, cancel_event)
                    except RequestShedError as e:
                        # abandon the stream; the transfer is still acked
                        if tr is not None:
                            tr.add_phase(
                                "decode_steady" if t_first_tok is not None
                                else "decode_first_token",
                                (time.perf_counter()
                                 - (t_first_tok or t_dec)) * 1e3,
                                replica=rep.rid, tokens=n_attempt_toks,
                                error=getattr(e, "cause", None) or "shed")
                        try:
                            self._tier_call(rep, "decode", "cancel_decode",
                                            hid, getattr(e, "cause", None),
                                            block=False)
                        except Exception:  # noqa: BLE001 — dead too
                            pass
                        self._ack_transfer(pf, rec)
                        raise
                    if time.perf_counter() - last_progress > timeout_s:
                        raise TimeoutError(
                            f"decode stream stalled > {timeout_s:.0f}s "
                            f"on {rep.rid}")
            except RequestShedError:
                raise
            except Exception as e:  # noqa: BLE001 — death or stall
                if tr is not None and t_dec is not None:
                    # the failed attempt's partial decode is a phase of
                    # its own
                    tr.add_phase(
                        "decode_steady" if t_first_tok is not None
                        else "decode_first_token",
                        (time.perf_counter() - (t_first_tok or t_dec))
                        * 1e3, replica=rep.rid, tokens=n_attempt_toks,
                        error=type(e).__name__)
                if preempt_resume():
                    # the handle vanished under a preemption: resume
                    # without an attempt, the replica is alive
                    self._ack_transfer(pf, rec)
                    continue
                if _is_pool_exhausted(e):
                    self._ack_transfer(pf, rec)
                    raise self._shed_pool_exhausted("decode", tenant,
                                                    e) from e
                try:
                    self._check_request_fault(tenant, e)
                except ValueError:
                    self._ack_transfer(pf, rec)
                    raise
                fail_detected = time.perf_counter()
                had_failover = True
                if hid is not None:
                    # a live but stalled replica keeps the slot unless
                    # cancelled; on a dead one this fails harmlessly
                    try:
                        _call(rep.target, "cancel_decode", hid, "failover",
                              block=False)
                    except Exception:  # noqa: BLE001 — replica dead
                        pass
                self._ack_transfer(pf, rec)
                self._attempt_failed("decode", rep.rid, attempt, e, tenant)
                if tr is not None:
                    tr.begin_attempt()
                rep_box[0] = self._reserve_survivor(rep, deadline, tenant)
                continue
            finally:
                if pslot is not None:
                    with self._lock:
                        pslot.cancel_fn = None

    # ------------------------------------------------------------ telemetry

    def signals(self) -> Dict[str, Any]:
        """The recent signals an autoscaling policy reads (a key is
        absent while there is no evidence)."""
        sig: Dict[str, Any] = {}
        for key, win, field in (("ttft_p99_ms", self._ttft_win, "p99"),
                                ("queue_depth_p99", self._depth_win, "p99"),
                                ("prefill_inflight_p99",
                                 self._pf_inflight_win, "p99"),
                                ("cache_hit_rate", self._cache_win, "mean")):
            summary = win.summary()
            if summary["n"]:
                sig[key] = summary[field]
        return sig

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
            s["pending"] = sum(r.inflight for r in self._decode)
            s["failovers"] = dict(self._sf["failovers"])
            s["failover_requests"] = self._sf["failover_requests"]
            s["sheds_by_cause"] = dict(self._sf["sheds_by_cause"])
            decode = list(self._decode)
            prefill = list(self._prefill)
        s.update(role="router", router_id=self.router_id,
                 mode="disagg" if self._disagg_mode else "colocated",
                 decode_replicas=sum(1 for r in decode if not r.draining),
                 prefill_replicas=sum(1 for r in prefill if not r.draining),
                 draining_replicas=sum(1 for r in decode + prefill
                                       if r.draining),
                 capacity=sum(r.cap for r in decode if not r.draining),
                 max_queue_depth=self.max_queue_depth,
                 retry_after_s=self.retry_after_s)
        if s["shm_affinity_total"]:
            s["shm_affinity_hit_rate"] = round(
                s["shm_affinity_hits"] / s["shm_affinity_total"], 4)
        if s["tenant_affinity_total"]:
            s["tenant_affinity_hit_rate"] = round(
                s["tenant_affinity_hits"] / s["tenant_affinity_total"], 4)
        tenants = self.tenant_stats()
        if tenants:
            s["tenants"] = tenants
        s["recent"] = {"ttft_ms": self._ttft_win.summary(),
                       "queue_depth": self._depth_win.summary(),
                       "prefill_inflight": self._pf_inflight_win.summary(),
                       "cache_hit_rate": self._cache_win.summary()}
        return s

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant counters and recent TTFT / latency windows."""
        with self._lock:
            return {t: {"dispatched": rec["dispatched"],
                        "completed": rec["completed"], "shed": rec["shed"],
                        "sheds_by_cause": dict(rec["sheds_by_cause"]),
                        "slo_misses": rec["slo_misses"],
                        "ttft_ms": rec["ttft"].summary(),
                        "latency_ms": rec["latency"].summary()}
                    for t, rec in self._tenant_stats.items()}

    def kvplane_stats(self) -> Dict[str, Any]:
        """The router's directory outcomes: hit (routed to the holder),
        fallback (holder gone: hash plus a tier-3 hint), miss."""
        with self._lock:
            s: Dict[str, Any] = {k: self._stats[k] for k in (
                "directory_hits", "directory_misses",
                "directory_fallbacks")}
        s.update(role="router", router_id=self.router_id,
                 enabled=self._kvplane_dir,
                 kv_block_size=self._kv_block_size)
        probes = (s["directory_hits"] + s["directory_misses"]
                  + s["directory_fallbacks"])
        if probes:
            s["directory_hit_rate"] = round(s["directory_hits"] / probes, 4)
        return s

    def publish_telemetry(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_push < 0.5:
            return
        self._last_push = now
        _push("report_disagg_stats", self.router_id, self.stats())
        if self._disagg_mode and self._kvplane_dir:
            _push("report_kvplane_stats", self.router_id,
                  self.kvplane_stats())
        tenants = self.tenant_stats()
        if tenants:
            # the router's tenant counters ride the lora surface beside
            # the pools' paging stats
            with self._lock:
                hits = self._stats["tenant_affinity_hits"]
                total = self._stats["tenant_affinity_total"]
            _push("report_lora_stats", self.router_id,
                  {"role": "router", "router_id": self.router_id,
                   "tenant_affinity_hits": hits,
                   "tenant_affinity_total": total, "tenants": tenants})

    def servefault_stats(self) -> Dict[str, Any]:
        """The fault-tolerance snapshot of this router."""
        with self._lock:
            sf: Dict[str, Any] = {
                "failovers": dict(self._sf["failovers"]),
                "failover_requests": self._sf["failover_requests"],
                "sheds_by_cause": dict(self._sf["sheds_by_cause"]),
                "removed_dead": dict(self._sf["removed_dead"])}
        sf.update(role="router", router_id=self.router_id,
                  recent_failover_recovery_ms=self._failover_win.summary())
        return sf

    def publish_servefault(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_sf_push < 0.5:
            return
        self._last_sf_push = now
        _push("report_servefault_stats", self.router_id,
              self.servefault_stats())


__all__ = ["DecodeServer", "DisaggRouter", "PrefillServer",
           "ReplicaDeadError", "RequestShedError", "disagg_metrics",
           "servefault_metrics"]
