"""Cluster state views (part of the port of ray_tpu/util/state.py): the
flight recorder's training progress, the weight fabric's registry, the
recovery subsystem, disaggregated serving, the global KV plane, serving
fault tolerance, the serving autoscaler, the online learning loop and
the MPMD pipelines. The rest of that module
(task, actor and the other serving views, the merged timeline export)
waits for ROADMAP Queue 1 item 8; so do the CLI, dashboard and
Prometheus surfaces of these views.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


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


__all__ = ["autoscaler_status", "disagg_status", "kvplane_status",
           "online_status", "pipeline_status", "resilience_status",
           "servefault_status", "train_progress", "weight_versions"]
