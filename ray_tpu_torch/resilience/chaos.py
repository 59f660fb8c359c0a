"""Chaos harness: deterministic, scriptable fault injection (port of
ray_tpu/resilience/chaos.py).

A chaos *plan* is a JSON list of actions ("kill rank 2 at step 5",
"preempt host H with 3 seconds of grace", "delay heartbeats by 500
ms"). A :class:`ChaosMonkey` built from the plan is consulted at every
training step boundary (``ray_tpu_torch.train.report``) and fires each
matching action exactly once.

Where the port differs: the plan is an argument, never the
``RAY_TPU_CHAOS_PLAN`` environment variable the JAX package reads.
``TorchTrainer(chaos_plan=)`` forwards it to every rank,
``NodeAgent(chaos_plan=)`` stretches its heartbeats by it and
``ChunkFetcher(chaos_plan=)`` delays each pull by it. A plan is a
:class:`ChaosPlan`, or its spec: inline JSON or ``@/path/plan.json``.

Actions (all fields beyond ``action`` optional unless noted):

- ``{"action": "raise", "rank": R, "at_step": S}``: raise
  :class:`ChaosError` inside the training loop (the trainer's retry
  path catches it).
- ``{"action": "kill", "rank": R, "at_step": S}``: hard ``os._exit`` of
  the rank's process (a worker death).
- ``{"action": "preempt", "node": N, "grace_s": G, "at_step": S}``:
  report a preemption for node N (a node id, ``"head"``, or ``"self"``,
  the firing rank's host) to the conductor, which broadcasts the
  checkpoint-now notice and drains the host.
- ``{"action": "delay_heartbeats", "ms": M}``: node agents stretch
  their heartbeat period by M ms.
- ``{"action": "delay_chunk_fetch", "ms": M}``: every chunk pull sleeps
  M ms first.
- ``{"action": "bounce_conductor", "at_step": S}``: matched by
  :meth:`ChaosPlan.external_actions`; the harness executes it.
- The serving plane's ``kill_replica``, ``drop_connection`` and
  ``evict_storm`` parse as in the JAX package; their executor
  (``ServeChaosMonkey``) waits for the port of ``serve/``.

``at_step`` compares against the step being reported (the ``step``
metric when present, else the session's report count, 1-based).
``attempt`` (default 0) scopes an action to one restart generation;
``"attempt": "any"`` fires every time the step matches. ``rank``
defaults to 0 for ``preempt`` and is required for ``raise`` / ``kill``.
"""
from __future__ import annotations

import json
import os
import re
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

_IN_PROCESS = ("raise", "kill", "preempt")
_EXTERNAL = ("bounce_conductor",)
_PASSIVE = ("delay_heartbeats", "delay_chunk_fetch")
_SERVE = ("kill_replica", "drop_connection", "evict_storm")

_AT_RE = re.compile(r"^(token|request):(\d+)$")


class ChaosError(RuntimeError):
    """A scripted, survivable failure injected by the chaos harness."""


@dataclass
class ChaosAction:
    action: str
    at_step: int = 0
    rank: Optional[int] = None
    attempt: Any = 0            # int generation, or "any"
    node: Optional[str] = None  # preempt: node id | "head" | "self"
    grace_s: Optional[float] = None
    ms: float = 0.0             # delay_heartbeats / delay_chunk_fetch
    role: Optional[str] = None  # serving actions
    at: Optional[str] = None    # serving actions: "token:K" | "request:N"
    replica: int = 0
    blocks: int = 0             # evict_storm

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChaosAction":
        action = str(d.get("action", ""))
        known = _IN_PROCESS + _EXTERNAL + _PASSIVE + _SERVE
        if action not in known:
            raise ValueError(f"unknown chaos action {action!r}; "
                             f"known: {sorted(known)}")
        if action in ("raise", "kill") and d.get("rank") is None:
            raise ValueError(f"chaos action {action!r} requires a rank")
        if action == "kill_replica":
            if d.get("role") not in ("prefill", "decode"):
                raise ValueError("chaos action 'kill_replica' requires "
                                 "role=prefill|decode")
            if not _AT_RE.match(str(d.get("at", ""))):
                raise ValueError("chaos action 'kill_replica' requires "
                                 "at='token:K'|'request:N'")
        if action == "evict_storm":
            if d.get("role") not in (None, "prefill"):
                raise ValueError("chaos action 'evict_storm' fires at a "
                                 "prefill replica's prefix pool "
                                 "(role=prefill or omitted)")
            d = dict(d, role="prefill")
            if int(d.get("blocks", 0)) < 1:
                raise ValueError(
                    "chaos action 'evict_storm' requires blocks>=1")
            if not _AT_RE.match(str(d.get("at", ""))):
                raise ValueError("chaos action 'evict_storm' requires "
                                 "at='token:K'|'request:N'")
        if action == "drop_connection":
            if d.get("role") not in (None, "gateway"):
                raise ValueError("chaos action 'drop_connection' fires at "
                                 "the gateway (role=gateway or omitted)")
            d = dict(d, role="gateway")
            if not _AT_RE.match(str(d.get("at", ""))):
                raise ValueError("chaos action 'drop_connection' requires "
                                 "at='token:K'|'request:N'")
        return cls(action=action,
                   at_step=int(d.get("at_step", 0)),
                   rank=None if d.get("rank") is None else int(d["rank"]),
                   attempt=d.get("attempt", 0),
                   node=d.get("node"),
                   grace_s=(None if d.get("grace_s") is None
                            else float(d["grace_s"])),
                   ms=float(d.get("ms", 0.0)),
                   role=d.get("role"),
                   at=None if d.get("at") is None else str(d["at"]),
                   replica=int(d.get("replica", 0)),
                   blocks=int(d.get("blocks", 0)))

    def matches(self, step: int, rank: int, attempt: int) -> bool:
        if self.action in _PASSIVE or self.action in _SERVE:
            return False  # consulted out of band, not stepwise
        if self.attempt != "any" and int(self.attempt) != attempt:
            return False
        if self.at_step != step:
            return False
        want = 0 if self.rank is None else self.rank
        return want == rank


class ChaosPlan:
    """An ordered list of actions, parsed from JSON."""

    def __init__(self, actions: List[ChaosAction], spec: str = ""):
        self.actions = list(actions)
        self.spec = spec

    def __bool__(self) -> bool:
        return bool(self.actions)

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> "ChaosPlan":
        """Parse inline JSON or ``@/path/to/plan.json``; None or "" is
        the empty plan. A malformed plan raises: silently dropping
        scripted faults would make a chaos test vacuously green."""
        if not spec:
            return cls([], "")
        text = spec
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                text = f.read()
        data = json.loads(text)
        if isinstance(data, dict):
            data = data.get("actions", [])
        return cls([ChaosAction.from_dict(d) for d in data], spec)

    def heartbeat_delay_s(self) -> float:
        """Extra node-agent heartbeat delay scripted by the plan."""
        return sum(a.ms for a in self.actions
                   if a.action == "delay_heartbeats") / 1000.0

    def chunk_fetch_delay_s(self) -> float:
        """Extra per-pull chunk-fetch delay scripted by the plan."""
        return sum(a.ms for a in self.actions
                   if a.action == "delay_chunk_fetch") / 1000.0

    def external_actions(self, step: int, attempt: int = 0
                         ) -> List[ChaosAction]:
        """Actions the harness itself must execute at this step (e.g.
        bounce_conductor): the monkey cannot, it lives inside the run."""
        return [a for a in self.actions
                if a.action in _EXTERNAL
                and a.matches(step, a.rank or 0, attempt)]


PlanLike = Union[ChaosPlan, str, None]


def as_plan(plan: PlanLike) -> ChaosPlan:
    """A ChaosPlan from a plan, its spec, or None (the empty plan)."""
    if isinstance(plan, ChaosPlan):
        return plan
    return ChaosPlan.from_spec(plan)


def heartbeat_delay_s(plan: PlanLike) -> float:
    """The node agent's heartbeat stretch under `plan`."""
    return as_plan(plan).heartbeat_delay_s()


def chunk_fetch_delay_s(plan: PlanLike) -> float:
    """The per-pull chunk-fetch stretch under `plan`."""
    return as_plan(plan).chunk_fetch_delay_s()


class ChaosMonkey:
    """Per-process executor of a plan's in-process actions.

    Created by the trainer for each fit attempt and consulted from
    ``train.report`` at every step boundary. Each action fires at most
    once per monkey; an action's ``attempt`` gives cross-restart
    determinism (a restarted run is a new monkey with a new attempt).
    """

    def __init__(self, plan: ChaosPlan, rank: int = 0, attempt: int = 0,
                 conductor_call: Optional[Callable[..., Any]] = None):
        self.plan = plan
        self.rank = int(rank)
        self.attempt = int(attempt)
        self._conductor_call = conductor_call
        self._fired: set = set()
        self._lock = threading.Lock()

    def on_step(self, step: int) -> None:
        """Fire every in-process action matching (step, rank, attempt).
        May raise ChaosError or end the process, by design."""
        for idx, a in enumerate(self.plan.actions):
            if a.action not in _IN_PROCESS:
                continue
            with self._lock:
                if idx in self._fired:
                    continue
                if not a.matches(step, self.rank, self.attempt):
                    continue
                self._fired.add(idx)
            self._execute(a, step)

    def _execute(self, a: ChaosAction, step: int) -> None:
        self._report_event(a, step)
        if a.action == "raise":
            raise ChaosError(
                f"chaos: injected failure at rank {self.rank} "
                f"step {step} (attempt {self.attempt})")
        if a.action == "kill":
            os._exit(137)
        if a.action == "preempt":
            self._preempt(a)

    def _call(self, method: str, *args, **kwargs) -> Any:
        if self._conductor_call is not None:
            return self._conductor_call(method, *args, **kwargs)
        from .._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is None:
            return None
        return w.conductor.call(method, *args, timeout=10.0, **kwargs)

    def _preempt(self, a: ChaosAction) -> None:
        node_id, worker_id = a.node, None
        if a.node in (None, "self"):
            node_id = None
            from .._private import worker as worker_mod

            w = worker_mod.global_worker
            worker_id = w.worker_id if w is not None else None
        elif a.node == "head":
            node_id = None  # the conductor defaults to its head node
        try:
            self._call("report_preemption", node_id, worker_id,
                       a.grace_s, "chaos")
        except Exception:  # noqa: BLE001 — conductor mid-bounce: the
            pass           # injection is lost, the plan is not

    def _report_event(self, a: ChaosAction, step: int) -> None:
        try:
            self._call("report_resilience_event", {
                "kind": "chaos", "action": a.action, "rank": self.rank,
                "step": step, "attempt": self.attempt, "node": a.node})
        except Exception:  # noqa: BLE001 — telemetry only
            pass


def monkey_from_spec(spec: PlanLike, rank: int = 0,
                     attempt: int = 0) -> Optional[ChaosMonkey]:
    """A monkey when `spec` (a plan or its spec) carries actions; None
    when there is no chaos configured. Nothing is read from the
    environment."""
    plan = as_plan(spec)
    if not plan:
        return None
    return ChaosMonkey(plan, rank=rank, attempt=attempt)


__all__ = ["ChaosAction", "ChaosError", "ChaosMonkey", "ChaosPlan",
           "as_plan", "chunk_fetch_delay_s", "heartbeat_delay_s",
           "monkey_from_spec"]
