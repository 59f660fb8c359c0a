"""Distributed tracing (the port's copy of the JAX package's
util/tracing.py): spans that follow tasks and actor calls across
processes — the role of the reference's OpenTelemetry integration
(python/ray/util/tracing/tracing_helper.py: _inject_tracing_into_function,
propagation over the task wire).

Zero-dependency by design: spans use the W3C traceparent format for
cross-process propagation, are buffered per process, flushed to the
conductor alongside task events (capped there at 100,000), and export
as chrome-trace (Perfetto) or OTLP-shaped JSON. If the real
`opentelemetry` package is importable, span start/ends are mirrored into
it so users with an OTel pipeline get the runtime's spans for free.

The switch is `enable()` in the driver: workers spawned after it find
RTT_TRACING in their environment, and a worker that receives a
traceparent on a task's wire turns tracing on itself. The device half
is `device_trace`, on torch.profiler.

Usage:
    from ray_tpu_torch.util import tracing
    tracing.enable()                 # driver: before submitting work
    with tracing.span("prepare-data", dataset="train"):
        ref = my_task.remote()       # child spans appear under this one
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_local = threading.local()
_lock = threading.Lock()
_finished: List["Span"] = []
_enabled = False
# the spawn wiring that carries the switch to workers (never RAY_TPU_*)
ENV_TRACING = "RTT_TRACING"


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float = field(default_factory=time.time)
    end: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    status: str = "OK"

    def traceparent(self) -> str:
        """W3C trace-context header value for cross-process hops."""
        return f"00-{self.trace_id}-{self.span_id}-01"


def _parse_traceparent(tp: str) -> Optional[Dict[str, str]]:
    parts = tp.split("-")
    if len(parts) != 4:
        return None
    return {"trace_id": parts[1], "span_id": parts[2]}


def enable() -> None:
    """Turn span recording on in THIS process and (via env inheritance)
    in workers spawned afterwards. Reference: `ray.init(_tracing_startup_hook)`."""
    global _enabled
    _enabled = True
    os.environ[ENV_TRACING] = "1"


def is_enabled() -> bool:
    return _enabled or os.environ.get(ENV_TRACING) == "1"


def current_span() -> Optional[Span]:
    return getattr(_local, "span", None)


def current_traceparent() -> Optional[str]:
    """What the submitter injects into the task wire."""
    if not is_enabled():
        return None
    s = current_span()
    if s is not None:
        return s.traceparent()
    # no active span: start an implicit trace root so remote spans of one
    # driver share a trace
    root = getattr(_local, "implicit_root", None)
    if root is None:
        root = uuid.uuid4().hex
        _local.implicit_root = root
    return f"00-{root}-{'0' * 16}-01"


@contextlib.contextmanager
def span(name: str, traceparent: Optional[str] = None, **attrs):
    """Open a span. `traceparent` (from a task wire) parents this span
    into the submitting process's trace; otherwise the current in-process
    span is the parent."""
    if not is_enabled():
        yield None
        return
    parent = current_span()
    if traceparent:
        ctx = _parse_traceparent(traceparent)
        trace_id = ctx["trace_id"] if ctx else uuid.uuid4().hex
        parent_id = ctx["span_id"] if ctx and ctx["span_id"].strip("0") \
            else None
    elif parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = current_traceparent().split("-")[1], None
    s = Span(name=name, trace_id=trace_id, span_id=uuid.uuid4().hex[:16],
             parent_id=parent_id, attrs=dict(attrs))
    prev, _local.span = current_span(), s
    otel = _otel_start(s)
    try:
        yield s
    except BaseException as e:
        s.status = f"ERROR: {type(e).__name__}"
        raise
    finally:
        s.end = time.time()
        _local.span = prev
        _otel_end(otel, s)
        with _lock:
            _finished.append(s)
            if len(_finished) > 100_000:
                del _finished[:50_000]


_NULL_CM = contextlib.nullcontext()


def submit_span(name: str):
    """Span wrapping a task/actor-call submission (`submit:<name>`), or
    a shared no-op context manager when tracing is off. The single
    authority for submission-span naming and enablement — used by
    remote_function.remote() and ActorHandle._invoke so the unified
    timeline's submit -> execute chain cannot diverge between the two."""
    if not is_enabled():
        return _NULL_CM
    return span(f"submit:{name}")


# ------------------------------------------------------------------ export

def drain() -> List[Dict[str, Any]]:
    """Pop finished spans as dicts (the flusher ships these to the
    conductor with the task-event batch)."""
    with _lock:
        out, _finished[:] = list(_finished), []
    return [{"name": s.name, "trace_id": s.trace_id, "span_id": s.span_id,
             "parent_id": s.parent_id, "start": s.start, "end": s.end,
             "attrs": s.attrs, "status": s.status, "pid": os.getpid()}
            for s in out]


def to_chrome_trace(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Perfetto/chrome://tracing events, one X event per span, grouped by
    process and trace."""
    return [{
        "name": sp["name"], "cat": "span", "ph": "X",
        "ts": sp["start"] * 1e6,
        "dur": max(0.0, (sp["end"] or sp["start"]) - sp["start"]) * 1e6,
        "pid": sp.get("pid", 0), "tid": sp["trace_id"][:8],
        "args": dict(sp["attrs"], status=sp["status"],
                     span_id=sp["span_id"],
                     parent_id=sp["parent_id"] or ""),
    } for sp in spans]


def _otlp_status(status: str) -> Dict[str, Any]:
    """OTLP status object. Error spans carry the recorded detail (the
    exception type after "ERROR: ") as status.message — previously the
    export collapsed every failure to a bare code=2."""
    if status == "OK":
        return {"code": 1}
    detail = status[len("ERROR: "):] if status.startswith("ERROR: ") \
        else status
    return {"code": 2, "message": detail}


def to_otlp_json(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """OTLP/JSON-shaped export for users piping into a collector."""
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": "ray_tpu_torch"}}]},
        "scopeSpans": [{"scope": {"name": "ray_tpu_torch.util.tracing"},
                        "spans": [{
            "traceId": sp["trace_id"],
            "spanId": sp["span_id"],
            "parentSpanId": sp["parent_id"] or "",
            "name": sp["name"],
            "startTimeUnixNano": int(sp["start"] * 1e9),
            "endTimeUnixNano": int((sp["end"] or sp["start"]) * 1e9),
            "status": _otlp_status(sp["status"]),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in sp["attrs"].items()],
        } for sp in spans]}],
    }]}


# ---------------------------------------------------- optional real OTel

def _otel_start(s: Span):
    try:
        from opentelemetry import trace as ot

        tracer = ot.get_tracer("ray_tpu_torch")
        span = tracer.start_span(s.name, attributes=s.attrs)
        return span
    except Exception:  # noqa: BLE001 — otel absent or misconfigured
        return None


def _otel_end(otel_span, s: Span) -> None:
    if otel_span is None:
        return
    try:
        otel_span.end()
    except Exception:  # noqa: BLE001
        pass


# ---------------------------------------------- torch.profiler bridging

@contextlib.contextmanager
def device_trace(logdir: str, device: Optional[str] = None):
    """Capture a torch.profiler trace (CPU ops and, on the card, CUDA
    kernels through CUPTI) around a block, written under `logdir` as a
    `*.pt.trace.json` (Perfetto / chrome://tracing). Host spans come
    from this module, device timelines from the profiler. `device="cpu"`
    traces CPU ops only; without it a process without CUDA raises."""
    from . import profiling

    with profiling.profile(log_dir=logdir, device=device):
        yield
