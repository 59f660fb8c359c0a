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
- ``{"action": "kill_replica", "role": "prefill"|"decode", "at":
  "token:K"|"request:N", "replica": R}``: hard ``os._exit`` of the
  matching disaggregated-serving replica's process (``serve/disagg.py``)
  once it has served its K-th decoded token (a death mid-stream) or at
  the start of its N-th request. ``replica`` (default 0) is the
  replica's creation index within its role. In a driver, where an
  in-process replica lives beside the user's program, the fire raises
  :class:`ChaosError` instead: nothing here ends a driver.
- ``{"action": "evict_storm", "role": "prefill", "blocks": B, "at":
  "request:N", "replica": R}``: force-evict B blocks of the matching
  prefill replica's prefix pool at the start of its N-th request (with
  the KV plane's host arena attached they spill there). Non-lethal: the
  replica takes the count with ``take_storm()``.
- ``drop_connection`` parses as in the JAX package; the HTTP gateway
  that executes it is not ported yet.

A plan handed to a serving replica (``chaos=``) may also be the list of
action dicts itself.

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

    def at_spec(self) -> Optional[tuple]:
        """("token"|"request", N) for a serving action."""
        m = _AT_RE.match(self.at or "")
        return (m.group(1), int(m.group(2))) if m else None

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

    def serve_actions(self, role: str, replica: int) -> List[ChaosAction]:
        """The serving-plane actions scoped to one replica of `role`."""
        return [a for a in self.actions
                if a.action in _SERVE and a.role == role
                and a.replica == int(replica)]

    def external_actions(self, step: int, attempt: int = 0
                         ) -> List[ChaosAction]:
        """Actions the harness itself must execute at this step (e.g.
        bounce_conductor): the monkey cannot, it lives inside the run."""
        return [a for a in self.actions
                if a.action in _EXTERNAL
                and a.matches(step, a.rank or 0, attempt)]


PlanLike = Union[ChaosPlan, str, List[Dict[str, Any]], None]


def as_plan(plan: PlanLike) -> ChaosPlan:
    """A ChaosPlan from a plan, its spec, its list of action dicts, or
    None (the empty plan)."""
    if isinstance(plan, ChaosPlan):
        return plan
    if isinstance(plan, (list, tuple)):
        return ChaosPlan([ChaosAction.from_dict(d) for d in plan],
                         json.dumps(list(plan)))
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


def exit_replica(code: int) -> None:
    """What a lethal serving action does: end this worker's process, or
    in a driver (or with no cluster) raise ChaosError, so an in-process
    replica never ends the program that holds it."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None or w.mode == "driver":
        raise ChaosError(f"chaos: kill_replica (exit code {code}) in a "
                         f"driver process raises instead of exiting")
    os._exit(code)


class ServeChaosMonkey:
    """Per-replica executor of a plan's serving actions.

    A disaggregated-serving replica (``serve/disagg.py``) builds one with
    its role and creation index and consults it at every request
    (``on_request``) and every batch of served tokens (``on_tokens``).
    Each action fires at most once; ``at`` counts are cumulative for this
    replica. `exit_fn` is what a lethal fire does (``exit_replica`` by
    default)."""

    def __init__(self, plan: ChaosPlan, role: str, replica: int = 0,
                 exit_fn: Optional[Callable[[int], Any]] = None):
        self.role = str(role)
        self.replica = int(replica)
        self.actions = plan.serve_actions(self.role, self.replica)
        self._exit = exit_fn if exit_fn is not None else exit_replica
        self._lock = threading.Lock()
        self._fired: set = set()
        self._tokens = 0
        self._requests = 0
        # a fired evict_storm latches its block count here; the replica
        # applies the eviction itself (take_storm)
        self._pending_storm = 0

    def __bool__(self) -> bool:
        return bool(self.actions)

    def take_storm(self) -> int:
        """Pop the pending evict_storm block count (0 when none is due)."""
        with self._lock:
            n, self._pending_storm = self._pending_storm, 0
        return n

    def reset_counts(self) -> None:
        """Zero the request and token counts; fired evict_storm actions
        re-arm (a fired kill already took its process)."""
        with self._lock:
            self._tokens = 0
            self._requests = 0
            self._fired -= {i for i, a in enumerate(self.actions)
                            if a.action == "evict_storm"}
            self._pending_storm = 0

    def on_request(self) -> None:
        """One request admitted (a prefill call, a decode adoption)."""
        with self._lock:
            self._requests += 1
            fire = self._due_locked("request", self._requests)
        if fire is not None:
            self._fire(fire)

    def on_tokens(self, n: int = 1) -> None:
        """`n` more tokens served by this replica."""
        with self._lock:
            self._tokens += int(n)
            fire = self._due_locked("token", self._tokens)
        if fire is not None:
            self._fire(fire)

    def _due_locked(self, kind: str, count: int) -> Optional[ChaosAction]:
        for idx, a in enumerate(self.actions):
            if idx in self._fired:
                continue
            spec = a.at_spec()
            if spec is not None and spec[0] == kind and count >= spec[1]:
                self._fired.add(idx)
                return a
        return None

    def _fire(self, a: ChaosAction) -> None:
        try:
            from .._private import worker as worker_mod

            w = worker_mod.global_worker
            if w is not None:
                ev = {"kind": "chaos", "action": a.action,
                      "role": self.role, "replica": self.replica,
                      "at": a.at, "tokens": self._tokens,
                      "requests": self._requests}
                if a.action == "evict_storm":
                    ev["blocks"] = a.blocks
                w.conductor.call("report_resilience_event", ev,
                                 timeout=5.0)
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        if a.action == "evict_storm":
            with self._lock:
                self._pending_storm += max(0, int(a.blocks))
            return
        self._exit(137)


def serve_monkey_from_spec(spec: PlanLike, role: str, replica: int = 0,
                           exit_fn: Optional[Callable[[int], Any]] = None
                           ) -> Optional[ServeChaosMonkey]:
    """A serving monkey when `spec` carries serving actions for this
    (role, replica); None otherwise, so the hot path pays one None check.
    A malformed plan raises. Nothing is read from the environment."""
    plan = as_plan(spec)
    if not plan:
        return None
    monkey = ServeChaosMonkey(plan, role, replica, exit_fn)
    return monkey if monkey else None


__all__ = ["ChaosAction", "ChaosError", "ChaosMonkey", "ChaosPlan",
           "ServeChaosMonkey", "as_plan", "chunk_fetch_delay_s",
           "exit_replica", "heartbeat_delay_s", "monkey_from_spec",
           "serve_monkey_from_spec"]
