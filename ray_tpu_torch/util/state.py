"""Cluster state API (the port of ray_tpu/util/state.py) — analog of
the reference's python/ray/util/state/ (api.py: list_actors :788,
list_tasks :1020, list_objects :1066, summarize_tasks :1382; backed by
the dashboard StateHead + GCS GcsTaskManager). Here the conductor IS the
state authority; workers answer store-stats probes directly.

The general views (nodes, workers, actors, placement groups, tasks,
objects, the task summary, the timeline, Prometheus text, RPC stats, the
cluster summary) and the views of the ported subsystems: the flight
recorder's training progress, the weight fabric's registry, the recovery
subsystem, disaggregated serving, the global KV plane, serving fault
tolerance, the serving autoscaler, the online learning loop, the MPMD
pipelines, the paged KV cache, speculation, LoRA tenants, the request
flight recorder and the HTTP gateway. The CLI's views
(scripts/cli.py, `--json`) print these dicts, and the dashboard
(dashboard/) serves the same conductor calls. The oracle's view waits
with its subsystem (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional


def _worker():
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    return w


def train_progress(run: Optional[str] = None) -> Dict[str, Any]:
    """Gang-wide training telemetry: {run_id: {world, last_step,
    per_rank: {rank: {mean_ms, p50_ms, p99_ms, tokens_per_sec, mfu,
    ...}}, last_step_skew, last_step_breakdown, phase_summary,
    stragglers}}, from the step records every rank's StepTimer ships
    (see observability.gang). `run` filters to one run id."""
    out = _worker().conductor.call("get_train_progress", timeout=30.0)
    if run is not None:
        out = {k: v for k, v in out.items() if k == run}
    return out


def weight_versions(name: Optional[str] = None) -> Dict[str, Any]:
    """The live weight fabric's registry: per name the latest committed
    version and the kept manifests' summaries (version, step, run_id,
    bytes, host, leaf and chunk counts), plus the publishes still
    pending. `name` filters to one weight set."""
    out = _worker().conductor.call("get_weight_versions", timeout=10.0)
    if name is not None:
        out = {"names": {k: v for k, v in out.get("names", {}).items()
                         if k == name},
               "pending": [p for p in out.get("pending", [])
                           if p.get("name") == name]}
    return out


def resilience_status() -> Dict[str, Any]:
    """The recovery subsystem: per-host failure scores with quarantine
    and drain flags, the excluded hosts, event counters (preemption,
    restart, quarantine, grace_checkpoint, ...), the last time to
    recovery and the most recent events."""
    return _worker().conductor.call("get_resilience_status", timeout=10.0)


def disagg_status() -> Dict[str, Any]:
    """Disaggregated serving (serve/disagg.py): the latest snapshot of
    each prefill server (prefills, prefix reuse, published transfers and
    bytes), decode server (transfers, KV bytes split shm / rpc,
    adoptions, free slots, prefill programs: 0 on a pure decode replica)
    and router (dispatched, shed, live and peak queue depth), grouped by
    role, plus cluster totals."""
    return _worker().conductor.call("get_disagg_status", timeout=10.0)


def kvplane_status() -> Dict[str, Any]:
    """The global KV plane (serve/kvplane.py): per-component snapshots
    (the prefill servers' tier-2 arenas and tier-3 counters, the
    routers' directory outcomes), cluster totals with the tier-2 and
    directory hit rates, and the prefix directory's summary (entries,
    bytes, per-namespace counts, commit / reap / GC counters)."""
    return _worker().conductor.call("get_kvplane_status", timeout=10.0)


def servefault_status() -> Dict[str, Any]:
    """Serving fault tolerance: per-router failovers by phase, sheds by
    cause, dead replicas removed and recent failover recovery times,
    plus cluster totals. The failover markers ride the timeline's
    resilience lane."""
    return _worker().conductor.call("get_servefault_status", timeout=10.0)


def autoscaler_status() -> Dict[str, Any]:
    """The serving autoscaler (serve/autoscale.py): each loop's latest
    status (per-tier active replicas and bounds, scale-up / scale-down
    decisions, drain outcomes, replica-seconds, the last decision's
    reason, the self-healer's deaths and replacements) plus cluster
    totals. The decisions' markers ride the timeline's autoscale lane."""
    return _worker().conductor.call("get_autoscale_status", timeout=10.0)


def online_status() -> Dict[str, Any]:
    """The online learning loop (online/): the latest snapshot of each
    sampler (rollouts, tokens, serving and latest version, staleness and
    its high-water mark), rollout buffer (occupancy, capacity, rejected
    puts) and learner (steps, ingested rollouts and tokens, the last
    published version), grouped by role, plus cluster totals."""
    return _worker().conductor.call("get_online_status", timeout=10.0)


def pipeline_status(name: Optional[str] = None) -> Dict[str, Any]:
    """MPMD pipelines (mpmd/): per pipeline the stage registry (formed
    flag, each stage's slice and worker identity), per-stage run stats
    (steps, bubble fraction, channel bytes, metric snapshots), cross-stage
    totals, and the channel mailbox's depth. `name` filters to one
    pipeline."""
    out = _worker().conductor.call("get_pipeline_status", timeout=10.0)
    if name is not None:
        out = {"pipelines": {k: v for k, v
                             in out.get("pipelines", {}).items()
                             if k == name},
               "mailbox_depth": out.get("mailbox_depth")}
    return out


def kv_cache_stats(engine: Optional[str] = None) -> Dict[str, Any]:
    """The paged KV prefix cache (models/kvcache.py): each engine's
    snapshot (hits, misses, evictions, pool utilization, reused and
    prefilled tokens) and cluster totals with the hit and token-reuse
    rates. `engine` filters to one engine id."""
    out = _worker().conductor.call("get_kvcache_stats", timeout=10.0)
    if engine is not None:
        out = {"engines": {k: v for k, v in out.get("engines", {}).items()
                           if v.get("engine_id") == engine},
               "totals": out.get("totals", {})}
    return out


def speculation_totals(engines: Dict[str, Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """The one speculation rollup (counter sums, acceptance rate, tokens
    per verify), shared by the conductor and `speculation_stats`'s
    engine filter so the two views cannot disagree."""
    totals: Dict[str, Any] = {
        k: sum(int(e.get(k, 0)) for e in engines.values())
        for k in ("spec_proposed", "spec_accepted",
                  "spec_verify_ticks", "spec_emitted_tokens")}
    totals["acceptance_rate"] = (
        totals["spec_accepted"] / totals["spec_proposed"]
        if totals["spec_proposed"] else 0.0)
    totals["tokens_per_verify"] = (
        totals["spec_emitted_tokens"] / totals["spec_verify_ticks"]
        if totals["spec_verify_ticks"] else 0.0)
    totals["engines"] = len(engines)
    return totals


def speculation_stats(engine: Optional[str] = None) -> Dict[str, Any]:
    """Speculative decoding (models/engine.py): each speculating
    engine's draft counters (proposed, accepted, verify steps, tokens
    per verify, acceptance rate, the int8-KV flag) and cluster totals,
    from the same snapshots as `kv_cache_stats`. `engine` filters to
    one engine id; the totals then describe that engine."""
    out = _worker().conductor.call("get_speculation_stats", timeout=10.0)
    if engine is not None:
        engines = {k: v for k, v in out.get("engines", {}).items()
                   if v.get("engine_id") == engine}
        out = {"engines": engines, "totals": speculation_totals(engines)}
    return out


def lora_status() -> Dict[str, Any]:
    """Multi-tenant LoRA serving (serve/lora.py): each adapter pool's
    paging snapshot (slots, residents, hits, misses, evictions, hot
    swaps, page-in bytes), each router's tenant counters, a per-tenant
    rollup and cluster totals."""
    return _worker().conductor.call("get_lora_status", timeout=10.0)


def gateway_status() -> Dict[str, Any]:
    """HTTP front-door view (serve/gateway.py): per-replica request
    counters split by priority class (interactive / batch accepted /
    completed / shed / disconnects) and status code, recent TTFT windows
    per class, the QoS gate's admission stats, batch-slot preemptions,
    and cluster totals. The accept / first_byte / preempt / rate_limit /
    disconnect markers ride the merged timeline's ``gateway`` lane."""
    return _worker().conductor.call("get_gateway_status", timeout=10.0)


def requesttrace_status() -> Dict[str, Any]:
    """The request flight recorder (observability/requests.py): each
    store's retention counters (completed, kept, dropped, outcomes,
    replayed and preempted requests), the cluster's slowest requests
    with their phase breakdowns, and the p99 attribution over every
    store's recent summaries."""
    return _worker().conductor.call("get_requesttrace_status",
                                    timeout=10.0)


def request_trace(request_id: str) -> Optional[Dict[str, Any]]:
    """One request's kept trace by id (None when it was sampled out or
    aged out): outcome, attempts, its phases tagged with their attempt,
    and the phases tiers in other processes pushed (`remote_phases`)."""
    return _worker().conductor.call("get_request_trace", str(request_id),
                                    timeout=10.0)


def list_nodes() -> List[Dict[str, Any]]:
    return _worker().conductor.call("nodes", timeout=10.0)


def list_workers() -> List[Dict[str, Any]]:
    return _worker().conductor.call("list_workers", timeout=10.0)


def list_actors(state: Optional[str] = None) -> List[Dict[str, Any]]:
    actors = _worker().conductor.call("list_actors", timeout=10.0)
    if state is not None:
        actors = [a for a in actors if a.get("state") == state]
    return actors


def list_placement_groups() -> List[Dict[str, Any]]:
    return _worker().conductor.call("list_placement_groups", timeout=10.0)


def list_tasks(limit: int = 10_000,
               name: Optional[str] = None) -> List[Dict[str, Any]]:
    w = _worker()
    events = w.conductor.call("get_task_events", limit, timeout=30.0)
    with w._task_events_lock:  # include this process's unflushed batch
        events = events + list(w._task_events)
    if name is not None:
        events = [e for e in events if e.get("name") == name]
    return events


def list_objects() -> List[Dict[str, Any]]:
    """Per-process object-store stats (reference `ray memory` summary)."""
    w = _worker()
    out = [dict(w.store.stats(), worker_id=w.worker_id, is_driver=True)]
    for rec in list_workers():
        addr = rec.get("address")
        if not addr:
            continue
        try:
            out.append(w.clients.get(tuple(addr)).call("store_stats",
                                                       timeout=5.0))
        except Exception:  # noqa: BLE001 — worker mid-restart
            pass
    return out


def summarize_tasks() -> Dict[str, Any]:
    """Group task events by name — reference api.py summarize_tasks :1382."""
    return _summarize(list_tasks())


def _summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    groups: Dict[str, Dict[str, Any]] = defaultdict(
        lambda: {"count": 0, "failed": 0, "total_s": 0.0,
                 "min_s": float("inf"), "max_s": 0.0})
    for ev in events:
        g = groups[ev["name"]]
        dur = max(0.0, ev["end"] - ev["start"])
        g["count"] += 1
        g["failed"] += 1 if ev.get("status") == "FAILED" else 0
        g["total_s"] += dur
        g["min_s"] = min(g["min_s"], dur)
        g["max_s"] = max(g["max_s"], dur)
    for g in groups.values():
        g["mean_s"] = g["total_s"] / max(1, g["count"])
        if g["min_s"] == float("inf"):
            g["min_s"] = 0.0
    return dict(groups)


def timeline(filename: Optional[str] = None,
             merged: bool = False) -> List[Dict[str, Any]]:
    """Chrome-trace export of task events — reference `ray timeline`.
    Load the output in chrome://tracing or Perfetto. merged=True gives
    the unified timeline instead: task events, tracing spans, training
    steps and every subsystem's markers (observability/timeline.py)."""
    from ..observability import timeline as tl

    if merged:
        trace = tl.merged_timeline()
    else:
        trace = tl.task_trace_events(list_tasks())
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


# ---------------------------------------------------------------- metrics

def _prom_escape(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def prometheus_metrics() -> str:
    """Render all pushed metric snapshots in Prometheus text exposition
    format — reference python/ray/_private/prometheus_exporter.py. Samples
    are grouped per metric family (HELP/TYPE once, then ALL of the family's
    series contiguously, across workers) as strict parsers require."""
    per_worker = _worker().conductor.call("get_metrics", timeout=10.0)
    return _render_prometheus(per_worker)


def _render_prometheus(per_worker: Dict[str, Any]) -> str:
    """Pure renderer over the conductor's per-worker snapshots."""
    # family name -> list of (worker_id, snapshot dict)
    families: Dict[str, List[Any]] = {}
    for worker_id, snapshot in sorted(per_worker.items()):
        for m in snapshot:
            families.setdefault(m["name"], []).append((worker_id, m))

    def labels(keys, tag_json: str, worker_id: str, extra: str = "") -> str:
        vals = json.loads(tag_json) if tag_json else []
        parts = [f'{k}="{_prom_escape(v)}"' for k, v in zip(keys, vals)]
        parts.append(f'WorkerId="{worker_id[:12]}"')
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}"

    lines: List[str] = []
    for name, members in families.items():
        first = members[0][1]
        if first.get("description"):
            lines.append(f"# HELP {name} "
                         f"{_prom_escape(first['description'])}")
        mtype = first["type"] if first["type"] != "untyped" else "gauge"
        lines.append(f"# TYPE {name} {mtype}")
        for worker_id, m in members:
            keys = list(m.get("tag_keys") or ())
            if m["type"] == "histogram":
                for tag_json, buckets in m.get("buckets", {}).items():
                    acc = 0
                    for bound, n in zip(m["boundaries"], buckets):
                        acc += n
                        le = f'le="{bound}"'
                        lines.append(
                            f"{name}_bucket"
                            f"{labels(keys, tag_json, worker_id, le)}"
                            f" {acc}")
                    acc += buckets[-1]
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket"
                        f"{labels(keys, tag_json, worker_id, inf)}"
                        f" {acc}")
                    lines.append(f"{name}_sum"
                                 f"{labels(keys, tag_json, worker_id)} "
                                 f"{m['sums'][tag_json]}")
                    lines.append(f"{name}_count"
                                 f"{labels(keys, tag_json, worker_id)} "
                                 f"{m['counts'][tag_json]}")
            else:
                for tag_json, v in m.get("values", {}).items():
                    lines.append(
                        f"{name}{labels(keys, tag_json, worker_id)} {v}")
    return "\n".join(lines) + ("\n" if lines else "")


def rpc_stats() -> Dict[str, Dict[str, float]]:
    """Control-plane dispatch latency by RPC method (count, mean/max
    queue and handler ms) — see ConductorHandler.get_rpc_stats."""
    return _worker().conductor.call("get_rpc_stats", timeout=10.0)


def recent_logs(limit: int = 500) -> List[Dict[str, Any]]:
    """The newest worker output lines the head's log tailer saw."""
    return _worker().conductor.call("get_recent_logs", limit, timeout=10.0)


def cluster_summary() -> Dict[str, Any]:
    """One-call overview — reference `ray status`."""
    w = _worker()
    return {
        "timestamp": time.time(),
        "nodes": list_nodes(),
        "resources_total": w.conductor.call("cluster_resources",
                                            timeout=10.0),
        "resources_available": w.conductor.call("available_resources",
                                                timeout=10.0),
        "num_actors": len(list_actors()),
        "num_workers": len(list_workers()),
        "placement_groups": list_placement_groups(),
    }


__all__ = ["autoscaler_status", "cluster_summary", "disagg_status",
           "kv_cache_stats", "kvplane_status", "list_actors", "list_nodes",
           "list_objects", "list_placement_groups", "list_tasks",
           "list_workers", "lora_status", "online_status",
           "pipeline_status", "prometheus_metrics", "recent_logs",
           "request_trace", "requesttrace_status", "resilience_status",
           "rpc_stats", "servefault_status", "speculation_stats",
           "speculation_totals", "summarize_tasks", "timeline",
           "train_progress", "weight_versions"]
