"""Gang-wide step aggregation: skew and straggler detection (port of
ray_tpu/observability/gang.py).

Pure functions over the conductor's per-run ring buffer of
``{step -> {rank -> record}}`` (see ConductorHandler.report_train_steps),
so the math is unit-testable with simulated ranks. Per-host step-time
variance is exactly the signal that decided scaling behavior in
"Exploring the limits of Concurrency in ML Training on Google TPUs"
(PAPERS.md): a single slow host gates every synchronous step, so the
summary names it.

A rank is flagged a straggler when, over the trailing window, its step
duration exceeds ``k x median(gang)`` in a persistent fraction of steps
(one garbage-collection hiccup is not a straggler; a consistently slow
host is). ``k`` defaults to 1.5, the JAX package's RAY_TPU_STRAGGLER_K
default; the port reads no environment, callers pass ``k=``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .step_timer import percentile as _percentile
from .step_timer import summarize_records

DEFAULT_STRAGGLER_K = 1.5
STRAGGLER_WINDOW = 20          # trailing steps examined
STRAGGLER_MIN_FRACTION = 0.6   # slow in >= this fraction of window steps
STRAGGLER_MIN_STEPS = 3        # don't judge a rank on fewer samples


def _duration_ms(rec: Dict[str, Any]) -> Optional[float]:
    """A record's gang-relevant duration: device step when recorded
    (host-side data stalls are a different pathology), else total."""
    d = rec.get("device_step_ms") or 0.0
    return d if d > 0 else rec.get("total_ms")


def step_skew(by_rank: Dict[int, Dict[str, Any]]) -> Dict[str, float]:
    """min/median/p99/max duration across ranks for ONE step."""
    vals = sorted(v for v in (_duration_ms(r) for r in by_rank.values())
                  if v is not None)
    if not vals:
        return {}
    median = _percentile(vals, 0.5)
    return {
        "min_ms": vals[0],
        "median_ms": median,
        "p99_ms": _percentile(vals, 0.99),
        "max_ms": vals[-1],
        "max_over_median": vals[-1] / median if median > 0 else 0.0,
    }


def find_stragglers(steps: Dict[int, Dict[int, Dict[str, Any]]],
                    k: Optional[float] = None,
                    window: int = STRAGGLER_WINDOW,
                    min_fraction: float = STRAGGLER_MIN_FRACTION
                    ) -> List[int]:
    """Ranks persistently above ``k x median`` in the trailing window.

    Only steps with >= 2 reporting ranks count (a solo rank has no gang
    to lag behind); a rank must be slow in >= ``min_fraction`` of the
    counted steps where it reported, and must have reported at least
    ``STRAGGLER_MIN_STEPS`` counted steps — one noisy first step is not
    persistence."""
    k = DEFAULT_STRAGGLER_K if k is None else k
    recent = sorted(steps)[-window:]
    slow: Dict[int, int] = {}
    seen: Dict[int, int] = {}
    for s in recent:
        by_rank = steps[s]
        durs = {r: _duration_ms(rec) for r, rec in by_rank.items()}
        durs = {r: d for r, d in durs.items() if d is not None}
        if len(durs) < 2:
            continue
        vals = sorted(durs.values())
        median = _percentile(vals, 0.5)
        if median <= 0:
            continue
        for r, d in durs.items():
            seen[r] = seen.get(r, 0) + 1
            if d > k * median:
                slow[r] = slow.get(r, 0) + 1
    return sorted(r for r, n in slow.items()
                  if seen.get(r, 0) >= STRAGGLER_MIN_STEPS
                  and n / seen[r] >= min_fraction)


def summarize_run(steps: Dict[int, Dict[int, Dict[str, Any]]],
                  k: Optional[float] = None) -> Dict[str, Any]:
    """One run's gang summary: per-rank stats over the buffered window,
    latest-step skew, and the straggler list."""
    k = DEFAULT_STRAGGLER_K if k is None else k
    ranks: Dict[int, List[Dict[str, Any]]] = {}
    for by_rank in steps.values():
        for r, rec in by_rank.items():
            ranks.setdefault(r, []).append(rec)
    per_rank: Dict[int, Dict[str, Any]] = {}
    for r, recs in sorted(ranks.items()):
        durs = sorted(v for v in (_duration_ms(x) for x in recs)
                      if v is not None)
        last = max(recs, key=lambda x: x.get("step", -1))
        per_rank[r] = {
            "steps": len(recs),
            "last_step": last.get("step"),
            "mean_ms": sum(durs) / len(durs) if durs else 0.0,
            "p50_ms": _percentile(durs, 0.5),
            "p99_ms": _percentile(durs, 0.99),
            "last_total_ms": last.get("total_ms"),
            "tokens_per_sec": last.get("tokens_per_sec"),
            "mfu": last.get("mfu"),
        }
    last_step = max(steps) if steps else None
    stragglers = find_stragglers(steps, k=k)
    out: Dict[str, Any] = {
        "world": len(ranks),
        "last_step": last_step,
        "steps_buffered": len(steps),
        "per_rank": per_rank,
        "stragglers": stragglers,
        "straggler_k": k,
    }
    if last_step is not None:
        out["last_step_skew"] = step_skew(steps[last_step])
        # headline breakdown: the latest step's lowest reporting rank
        by_rank = steps[last_step]
        lead_rank = min(by_rank)
        lead = by_rank[lead_rank]
        out["last_step_breakdown"] = {
            key: lead[key] for key in
            ("data_wait_ms", "bubble_wait_ms", "compile_ms",
             "device_step_ms", "checkpoint_ms", "report_ms", "other_ms",
             "total_ms")
            if key in lead}
        # per-phase p50/p99 + trailing EMA over the lead rank's buffered
        # window — the shared step_timer.summarize_records derivation
        # (also used by the oracle validation harness and bench), so
        # train_progress consumers stop re-deriving it from raw records
        lead_recs = [steps[s][lead_rank] for s in sorted(steps)
                     if lead_rank in steps[s]]
        out["phase_summary"] = summarize_records(lead_recs)["phases"]
    return out
