"""Schedule-aware pipeline lint (port of ray_tpu/analysis/pipelines.py):
the analytic bubble-fraction estimate, rule ``pipeline-bubble``.

Pure stdlib. The MPMD stage-gangs report through here
(``ray_tpu_torch.mpmd``: ``PipelineConductor.form`` lints its schedule
before spawning a single actor).

The estimate: with S stages and M microbatches, every stage idles for
S-1 of the M+S-1 tick slots — (S-1)/(M+S-1) for GPipe's fill-drain, and
the identical warm-up + cool-down bubble for non-interleaved 1F1B (1F1B
bounds activation memory at O(S); it does not shrink the bubble). Above
20% the finding escalates to a warning with the M >= 4*S sizing rule
from ``parallel/pipeline.py``'s docstring as the fix hint.
"""
from __future__ import annotations

from typing import List

from .findings import Finding, INFO, WARNING

#: schedules the estimator knows; both share the warm-up bubble
PIPELINE_SCHEDULES = ("gpipe", "1f1b")

#: estimates above this fraction escalate INFO -> WARNING
BUBBLE_WARN_FRACTION = 0.20


def estimate_bubble_fraction(schedule: str, num_stages: int,
                             num_microbatches: int) -> float:
    """(S-1)/(M+S-1): GPipe's fill-drain bubble and 1F1B's equal
    warm-up/cool-down bubble."""
    s, m = int(num_stages), int(num_microbatches)
    if s < 1 or m < 1:
        raise ValueError(
            f"need num_stages >= 1 and num_microbatches >= 1, got "
            f"S={num_stages} M={num_microbatches}")
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         f"one of {sorted(PIPELINE_SCHEDULES)}")
    return (s - 1) / (m + s - 1)


def check_pipeline_schedule(num_stages: int, num_microbatches: int,
                            schedule: str = "gpipe", *,
                            where: str = "") -> List[Finding]:
    """Findings for one pipeline schedule: always an INFO naming the
    estimate, escalated to WARNING past ``BUBBLE_WARN_FRACTION`` with
    the M >= 4*S fix hint."""
    frac = estimate_bubble_fraction(schedule, num_stages,
                                    num_microbatches)
    s, m = int(num_stages), int(num_microbatches)
    loc = where or f"pipeline/{schedule}"
    label = ("1F1B warm-up bubble" if schedule == "1f1b"
             else "GPipe fill-drain bubble")
    msg = (f"{label}: est. {frac:.1%} idle per stage "
           f"((S-1)/(M+S-1) with S={s} stages, M={m} microbatches)")
    if frac > BUBBLE_WARN_FRACTION:
        return [Finding(
            "pipeline-bubble", WARNING, loc,
            msg + f" — exceeds {BUBBLE_WARN_FRACTION:.0%}",
            fix_hint=f"choose M >= 4*S (here M >= {4 * s}) to keep the "
                     "bubble under ~20% (parallel/pipeline.py)")]
    return [Finding("pipeline-bubble", INFO, loc, msg)]


__all__ = ["BUBBLE_WARN_FRACTION", "PIPELINE_SCHEDULES",
           "check_pipeline_schedule", "estimate_bubble_fraction"]
