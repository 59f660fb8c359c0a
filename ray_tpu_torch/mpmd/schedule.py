"""Pipeline schedules: per-stage tick order for MPMD execution (a copy
of ray_tpu/mpmd/schedule.py).

A schedule is, per stage, the exact sequence of forward/backward
microbatch ticks that stage executes; cross-stage ordering is enforced
by the activation/gradient channels (a tick blocks until its input
arrives), so these functions only need to emit a LOCALLY correct order
that is globally deadlock-free.

Two schedules (arXiv 2412.14374 §3; Megatron-LM's terminology):

- ``gpipe``: fill-drain — all M forwards, then all M backwards. Peak
  activation memory is O(M) per stage; bubble fraction (S-1)/(M+S-1).
- ``1f1b``: warm-up of (S-1-s) forwards on stage s, then steady-state
  strict 1F/1B alternation, then cool-down backwards. Same warm-up
  bubble as GPipe, but peak activation memory is O(S) — independent of
  M — which is what lets M grow to amortize the bubble.

``bubble_fraction`` is the analytic estimate shardlint reports
(`analysis` rule ``pipeline-bubble``): both schedules idle each stage
for S-1 of the M+S-1 tick slots, so keep M >= 4*S to stay under ~20%
(the rule `parallel/pipeline.py` documents).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

FORWARD = "F"
BACKWARD = "B"


@dataclass(frozen=True)
class Tick:
    """One unit of stage work: op is FORWARD or BACKWARD, mb the
    microbatch index."""

    op: str
    mb: int

    def __str__(self) -> str:
        return f"{self.op}{self.mb}"


def _validate(num_stages: int, num_microbatches: int) -> Tuple[int, int]:
    s, m = int(num_stages), int(num_microbatches)
    if s < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if m < 1:
        raise ValueError(
            f"num_microbatches must be >= 1, got {num_microbatches}")
    return s, m


def gpipe_schedule(stage: int, num_stages: int,
                   num_microbatches: int) -> List[Tick]:
    """Fill-drain: every forward, then every backward (same order on
    every stage; the channels impose the S-1 tick stagger)."""
    _s, m = _validate(num_stages, num_microbatches)
    return ([Tick(FORWARD, i) for i in range(m)]
            + [Tick(BACKWARD, i) for i in range(m)])


def one_f_one_b_schedule(stage: int, num_stages: int,
                         num_microbatches: int) -> List[Tick]:
    """Non-interleaved 1F1B for stage `stage` (0-based): warm-up of
    ``min(M, S-1-stage)`` forwards, steady-state 1F/1B alternation,
    cool-down backwards. The last stage has no warm-up — it alternates
    from the first microbatch, which is what bounds live activations at
    O(S) per stage."""
    s, m = _validate(num_stages, num_microbatches)
    warmup = min(m, s - 1 - int(stage))
    ticks: List[Tick] = [Tick(FORWARD, i) for i in range(warmup)]
    fwd, bwd = warmup, 0
    while bwd < m:
        if fwd < m:
            ticks.append(Tick(FORWARD, fwd))
            fwd += 1
        ticks.append(Tick(BACKWARD, bwd))
        bwd += 1
    return ticks


SCHEDULES = {"gpipe": gpipe_schedule, "1f1b": one_f_one_b_schedule}


def stage_schedule(schedule: str, stage: int, num_stages: int,
                   num_microbatches: int) -> List[Tick]:
    """The tick list stage `stage` executes under `schedule`."""
    try:
        fn = SCHEDULES[schedule]
    except KeyError:
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}; "
            f"one of {sorted(SCHEDULES)}") from None
    return fn(stage, num_stages, num_microbatches)


def max_live_activations(schedule: str, stage: int, num_stages: int,
                         num_microbatches: int) -> int:
    """Peak number of saved forward activations on `stage` (the memory
    argument for 1F1B): forwards minus backwards, maximized over the
    tick sequence."""
    live = peak = 0
    for t in stage_schedule(schedule, stage, num_stages,
                            num_microbatches):
        live += 1 if t.op == FORWARD else -1
        peak = max(peak, live)
    return peak


def bubble_fraction(schedule: str, num_stages: int,
                    num_microbatches: int) -> float:
    """Analytic pipeline-bubble estimate: idle fraction of each stage's
    timeline. Delegates to the ONE implementation shardlint reports
    from (analysis.pipelines rule ``pipeline-bubble``): (S-1)/(M+S-1)
    for GPipe's fill-drain and the identical warm-up + cool-down bubble
    for non-interleaved 1F1B (1F1B saves memory, not bubble)."""
    from ..analysis.pipelines import estimate_bubble_fraction

    s, m = _validate(num_stages, num_microbatches)
    return estimate_bubble_fraction(schedule, s, m)


def validate_dependencies(schedules: Dict[int, List[Tick]],
                          num_stages: int, num_microbatches: int) -> None:
    """Assert the per-stage tick lists are globally deadlock-free under
    channel semantics (test helper): simulate all stages, advancing any
    stage whose next tick's inputs are available, and require every
    tick to complete.

    Input availability: F(mb) on stage s needs F(mb) done on s-1;
    B(mb) on stage s needs F(mb) done on s AND B(mb) done on s+1."""
    done = {(s, t.op, t.mb): False
            for s, ticks in schedules.items() for t in ticks}
    pos = {s: 0 for s in schedules}

    def ready(s: int, t: Tick) -> bool:
        if t.op == FORWARD:
            return s == 0 or done.get((s - 1, FORWARD, t.mb), False)
        if not done.get((s, FORWARD, t.mb), False):
            return False
        return s == num_stages - 1 or \
            done.get((s + 1, BACKWARD, t.mb), False)

    progressed = True
    while progressed:
        progressed = False
        for s, ticks in schedules.items():
            while pos[s] < len(ticks) and ready(s, ticks[pos[s]]):
                done[(s, ticks[pos[s]].op, ticks[pos[s]].mb)] = True
                pos[s] += 1
                progressed = True
    stuck = {s: str(ticks[pos[s]]) for s, ticks in schedules.items()
             if pos[s] < len(ticks)}
    if stuck:
        raise AssertionError(f"schedule deadlocks at {stuck}")


__all__ = ["BACKWARD", "FORWARD", "SCHEDULES", "Tick", "bubble_fraction",
           "gpipe_schedule", "max_live_activations",
           "one_f_one_b_schedule", "stage_schedule",
           "validate_dependencies"]
