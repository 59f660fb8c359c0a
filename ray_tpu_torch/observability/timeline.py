"""Timeline markers (part of the port of ray_tpu/observability/
timeline.py): conductor task events, tracing spans, training step
records, resilience events, weight-fabric events and the other
subsystems' markers as chrome-trace events, merged into one sorted list.

- task events: pid = job id,       tid = executing worker
- spans:       pid = recording process, tid = trace id prefix
  (`util.tracing.to_chrome_trace`)
- step markers: pid = "train:<run_id>", tid = "rank <r>": one X event
  per step carrying the phase breakdown in args (`bubble_wait_ms` of a
  pipeline stage among them), plus a counter series for tokens/s and
  MFU; the records come from the step timer's conductor flush;
- resilience:  pid = "resilience", tid = event kind: instant markers for
  preemptions, restarts, quarantines, grace checkpoints, chaos
  injections and recoveries;
- weights:     pid = "weights",    tid = event kind: instant markers for
  publishes, fetches, hot swaps, GC and reaps;
- disagg:      pid = "disagg",     tid = event kind: disaggregated
  serving's kv_publish / kv_transfer / shed / preempt markers (a
  failover is a resilience marker);
- kvplane:     pid = "kvplane",    tid = event kind: the KV plane's
  spill / tier2_hit / tier3_publish / tier3_adopt / directory_hit /
  evict_storm / reap / gc markers;
- autoscale:   pid = "autoscale",  tid = event kind: the serving
  autoscaler's scale_up / drain / scale_down / scale_from_zero /
  replica_death / replace markers (drains, deaths, replacements and
  breaker trips are resilience markers too);
- online:      pid = "online",     tid = the sampler id, or the event
  kind for the learner's: the online loop's rollout / swap / ingest /
  publish markers;
- pipeline:    pid = "pipeline",   tid = "stage <s>" (or the event
  kind): one lane per MPMD stage-gang, its formation, run reports and
  death;
- kvcache:     pid = "kvcache",    tid = event kind: the paged KV
  cache's evict / invalidate markers;
- speculation: pid = "speculation", tid = event kind: the spec_accept /
  spec_reject markers, the spec_* slice of the kvcache channel;
- lora:        pid = "lora",       tid = event kind: adapter page_in /
  evict / swap markers;
- gateway:     pid = "gateway",    tid = event kind: the HTTP front
  door's accept / first_byte / preempt / rate_limit / disconnect
  markers;
- requests:    pid = "requests",   tid = request id prefix: each kept
  request trace as one enclosing X span and one X span per phase (a
  replay's phases carry an " a<n>" suffix).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def task_trace_events(task_events: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """Chrome-trace events for conductor task events."""
    out: List[Dict[str, Any]] = []
    for ev in task_events:
        worker = ev.get("worker")
        out.append({
            "name": ev["name"], "cat": "task", "ph": "X",
            "ts": ev["start"] * 1e6,
            "dur": max(0.0, ev["end"] - ev["start"]) * 1e6,
            "pid": ev.get("job_id", "job"),
            "tid": f"{worker[0]}:{worker[1]}" if worker else "driver",
            "args": {"task_id": ev["task_id"],
                     "status": ev.get("status", "FINISHED")},
        })
    return out


def step_trace_events(records: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """Chrome-trace events for flattened step records (each carries
    run_id and rank, see the conductor's get_train_steps)."""
    out: List[Dict[str, Any]] = []
    for rec in records:
        t0, t1 = rec.get("t_start"), rec.get("t_end")
        if t0 is None or t1 is None:
            continue
        pid = f"train:{rec.get('run_id', 'default')}"
        tid = f"rank {rec.get('rank', 0)}"
        args = {k: round(v, 3) for k, v in rec.items()
                if k.endswith("_ms") and isinstance(v, (int, float))}
        for key in ("tokens", "tokens_per_sec", "mfu"):
            if key in rec:
                args[key] = rec[key]
        out.append({
            "name": f"step {rec.get('step', '?')}", "cat": "train_step",
            "ph": "X", "ts": t0 * 1e6,
            "dur": max(0.0, t1 - t0) * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })
        # counter tracks: throughput / MFU trend lines under the steps
        counters = {}
        if rec.get("tokens_per_sec") is not None:
            counters["tokens_per_sec"] = round(rec["tokens_per_sec"], 1)
        if rec.get("mfu") is not None:
            counters["mfu_pct"] = round(100.0 * rec["mfu"], 3)
        if counters:
            out.append({"name": "throughput", "cat": "train_step",
                        "ph": "C", "ts": t1 * 1e6, "pid": pid,
                        "args": counters})
    return out


def resilience_trace_events(events: List[Dict[str, Any]]
                            ) -> List[Dict[str, Any]]:
    """One global-scope instant marker per resilience event, so failures
    and recoveries line up against the tracks they interrupted."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        where = next((ev[k] for k in ("node_id", "run_id", "name",
                                      "replica", "router", "host")
                      if ev.get(k) is not None), None)
        out.append({
            "name": f"{kind}:{where}" if where is not None else kind,
            "cat": "resilience", "ph": "i", "s": "g", "ts": ts * 1e6,
            "pid": "resilience", "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def weight_trace_events(events: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
    """Instant markers for weight-fabric events under pid "weights"."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        name = ev.get("name")
        ver = ev.get("version")
        label = f"{kind}:{name}" if name else kind
        if ver is not None:
            label += f"@v{ver}"
        out.append({
            "name": label, "cat": "weights", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "weights", "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def _instant_events(events: List[Dict[str, Any]], lane: str,
                    where_keys: tuple, size_keys: tuple
                    ) -> List[Dict[str, Any]]:
    """Instant markers under pid `lane`, tid = event kind, labelled with
    the first of `where_keys` present and each of `size_keys`."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        label = kind
        where = next((ev[k] for k in where_keys if ev.get(k)), None)
        if where:
            label += f":{where}"
        for key, unit in size_keys:
            if ev.get(key) is not None:
                label += f" {ev[key]}{unit}"
        out.append({
            "name": label, "cat": lane, "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": lane, "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def disagg_trace_events(events: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
    """Instant markers of disaggregated serving under pid "disagg"."""
    return _instant_events(events, "disagg", ("server", "router"),
                           (("bytes", "B"),))


def kvplane_trace_events(events: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Instant markers of the global KV plane under pid "kvplane"."""
    return _instant_events(events, "kvplane",
                           ("replica", "holder", "router"),
                           (("blocks", "blk"), ("nbytes", "B")))


def autoscale_trace_events(events: List[Dict[str, Any]]
                           ) -> List[Dict[str, Any]]:
    """Instant markers of the serving autoscaler under pid "autoscale",
    labelled kind:tier->target."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        label = kind
        if ev.get("tier"):
            label += f":{ev['tier']}"
        if ev.get("to") is not None:
            label += f"->{ev['to']}"
        out.append({
            "name": label, "cat": "autoscale", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "autoscale", "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def online_trace_events(events: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
    """Instant markers of the online loop under pid "online": one lane
    per sampler, the learner's events on lanes of their kind."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        label = kind
        if ev.get("sampler"):
            label += f":{ev['sampler']}"
        if ev.get("weights_version") is not None:
            label += f"@v{ev['weights_version']}"
        elif ev.get("version") is not None:
            label += f"@v{ev['version']}"
        out.append({
            "name": label, "cat": "online", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "online",
            "tid": str(ev.get("sampler") or kind),
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def pipeline_trace_events(events: List[Dict[str, Any]]
                          ) -> List[Dict[str, Any]]:
    """Instant markers of MPMD pipeline events (open, stage_registered,
    formed, stage_report, stage_death, closed): one lane per stage under
    pid "pipeline"."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        name = ev.get("pipeline")
        stage = ev.get("stage")
        label = f"{kind}:{name}" if name else kind
        if stage is not None:
            label += f"/stage{stage}"
        out.append({
            "name": label, "cat": "pipeline", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "pipeline",
            "tid": f"stage {stage}" if stage is not None else kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def kvcache_trace_events(events: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Instant markers of the paged KV cache under pid "kvcache" (the
    spec_* markers go to the speculation lane)."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        kind = str(ev.get("kind", "event"))
        if ts is None or kind.startswith("spec_"):
            continue
        label = kind
        if ev.get("outcome"):
            label += f":{ev['outcome']}"
        if ev.get("reused_tokens") is not None:
            label += f" +{ev['reused_tokens']}tok"
        out.append({
            "name": label, "cat": "kvcache", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "kvcache", "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def speculation_trace_events(events: List[Dict[str, Any]]
                             ) -> List[Dict[str, Any]]:
    """Instant markers of speculative decoding under pid "speculation":
    the spec_accept / spec_reject slice of the kvcache events."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        kind = str(ev.get("kind", "event"))
        if ts is None or not kind.startswith("spec_"):
            continue
        label = kind
        if ev.get("proposed") is not None:
            label += f" {ev.get('accepted', 0)}/{ev['proposed']}"
        out.append({
            "name": label, "cat": "speculation", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "speculation", "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def lora_trace_events(events: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """Instant markers of LoRA adapter paging under pid "lora"."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        label = kind
        if ev.get("tenant"):
            label += f":{ev['tenant']}"
        if ev.get("version") is not None:
            label += f"@v{ev['version']}"
        if ev.get("bytes") is not None:
            label += f" {ev['bytes']}B"
        out.append({
            "name": label, "cat": "lora", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "lora", "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def gateway_trace_events(events: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Instant markers of the HTTP front door under pid "gateway", so
    ingress pressure and preemptions read against the router's shed and
    transfer markers and the lora lane's tenant paging."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        ts = ev.get("ts")
        if ts is None:
            continue
        kind = str(ev.get("kind", "event"))
        label = kind
        if ev.get("class"):
            label += f":{ev['class']}"
        if ev.get("tenant"):
            label += f"@{ev['tenant']}"
        if ev.get("ttft_ms") is not None:
            label += f" {ev['ttft_ms']}ms"
        out.append({
            "name": label, "cat": "gateway", "ph": "i", "s": "g",
            "ts": ts * 1e6, "pid": "gateway", "tid": kind,
            "args": {k: v for k, v in ev.items()
                     if k != "ts" and v is not None},
        })
    return out


def requests_trace_events(events: List[Dict[str, Any]]
                          ) -> List[Dict[str, Any]]:
    """Spans of the kept request traces under pid "requests": per
    ``kind == "trace"`` record one enclosing span with the outcome and
    totals, and one span per phase at its offset from the request's
    start (the record's ts is its completion)."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        if ev.get("kind") != "trace":
            continue
        ts = float(ev.get("ts", 0.0))
        rid = str(ev.get("request_id", "?"))
        tid = rid[:12]
        total_ms = float(ev.get("total_ms", 0.0) or 0.0)
        t_start = ts - total_ms / 1e3
        out.append({
            "name": f"request {ev.get('outcome', '?')}",
            "cat": "request", "ph": "X", "ts": t_start * 1e6,
            "dur": max(0.0, total_ms) * 1e3,
            "pid": "requests", "tid": tid,
            "args": {"request_id": rid,
                     "outcome": ev.get("outcome"),
                     "attempts": ev.get("attempts", 1),
                     "preempts": ev.get("preempts", 0),
                     "total_ms": round(total_ms, 3)},
        })
        for ph in ev.get("phases", []) or []:
            name = str(ph.get("phase", "phase"))
            attempt = int(ph.get("attempt", 1) or 1)
            if attempt > 1:
                name += f" a{attempt}"
            dur_ms = float(ph.get("dur_ms", 0.0) or 0.0)
            t_ms = ph.get("t_ms")
            t0 = t_start + (float(t_ms) / 1e3 if t_ms is not None
                            else 0.0)
            args = {k: v for k, v in ph.items()
                    if k not in ("phase", "t_ms") and v is not None}
            out.append({
                "name": name, "cat": "request_phase", "ph": "X",
                "ts": t0 * 1e6, "dur": max(0.0, dur_ms) * 1e3,
                "pid": "requests", "tid": tid, "args": args,
            })
    return out


def merged_chrome_trace(task_events: List[Dict[str, Any]],
                        spans: List[Dict[str, Any]],
                        step_records: List[Dict[str, Any]],
                        resilience_events: Optional[
                            List[Dict[str, Any]]] = None,
                        weight_events: Optional[
                            List[Dict[str, Any]]] = None,
                        disagg_events: Optional[
                            List[Dict[str, Any]]] = None,
                        kvplane_events: Optional[
                            List[Dict[str, Any]]] = None,
                        autoscale_events: Optional[
                            List[Dict[str, Any]]] = None,
                        online_events: Optional[
                            List[Dict[str, Any]]] = None,
                        pipeline_events: Optional[
                            List[Dict[str, Any]]] = None,
                        kvcache_events: Optional[
                            List[Dict[str, Any]]] = None,
                        lora_events: Optional[
                            List[Dict[str, Any]]] = None,
                        requesttrace_events: Optional[
                            List[Dict[str, Any]]] = None,
                        gateway_events: Optional[
                            List[Dict[str, Any]]] = None
                        ) -> List[Dict[str, Any]]:
    """Merge the sources into one list sorted by time."""
    from ..util import tracing

    trace = task_trace_events(task_events)
    trace.extend(tracing.to_chrome_trace(spans))
    trace.extend(step_trace_events(step_records))
    if resilience_events:
        trace.extend(resilience_trace_events(resilience_events))
    if weight_events:
        trace.extend(weight_trace_events(weight_events))
    if disagg_events:
        trace.extend(disagg_trace_events(disagg_events))
    if kvplane_events:
        trace.extend(kvplane_trace_events(kvplane_events))
    if autoscale_events:
        trace.extend(autoscale_trace_events(autoscale_events))
    if online_events:
        trace.extend(online_trace_events(online_events))
    if pipeline_events:
        trace.extend(pipeline_trace_events(pipeline_events))
    if kvcache_events:
        trace.extend(kvcache_trace_events(kvcache_events))
        trace.extend(speculation_trace_events(kvcache_events))
    if lora_events:
        trace.extend(lora_trace_events(lora_events))
    if gateway_events:
        trace.extend(gateway_trace_events(gateway_events))
    if requesttrace_events:
        trace.extend(requests_trace_events(requesttrace_events))
    trace.sort(key=lambda e: e.get("ts", 0.0))
    return trace


def merged_timeline(limit: int = 10_000) -> List[Dict[str, Any]]:
    """Pull the task events, spans, step records and the resilience,
    weight, disagg, KV-plane, autoscale, online, pipeline, kvcache, LoRA,
    request-trace and gateway events from the live cluster and merge
    them. Flushes this process's pending task events and spans first, so
    a short driver's trace is complete."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    w._flush_task_events()  # spans ride the same flush
    return merged_chrome_trace(
        w.conductor.call("get_task_events", limit, timeout=30.0),
        w.conductor.call("get_spans", limit, timeout=30.0),
        w.conductor.call("get_train_steps", limit, timeout=30.0),
        w.conductor.call("get_resilience_events", limit, timeout=30.0),
        w.conductor.call("get_weight_events", limit, timeout=30.0),
        w.conductor.call("get_disagg_events", limit, timeout=30.0),
        w.conductor.call("get_kvplane_events", limit, timeout=30.0),
        w.conductor.call("get_autoscale_events", limit, timeout=30.0),
        w.conductor.call("get_online_events", limit, timeout=30.0),
        w.conductor.call("get_pipeline_events", limit, timeout=30.0),
        w.conductor.call("get_kvcache_events", limit, timeout=30.0),
        w.conductor.call("get_lora_events", limit, timeout=30.0),
        w.conductor.call("get_requesttrace_events", limit, timeout=30.0),
        w.conductor.call("get_gateway_events", limit, timeout=30.0))
