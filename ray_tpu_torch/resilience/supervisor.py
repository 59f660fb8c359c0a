"""Gang supervision for workers-mode training (port of
ray_tpu/resilience/supervisor.py).

A gang is only as alive as its slowest-dying member: when one rank's
process dies mid-collective, the survivors block inside gloo or NCCL
(in C++, where no Python-level cancel reaches them) until the group's
timeout. The supervisor rides the conductor's actor-death pubsub, so a
peer death is seen in milliseconds, and kills the survivors' processes
(`kill_actor`: SIGKILL on the head, the agent's shutdown notice
elsewhere). The restart decision stays with the trainer's retry loop,
which applies the backoff and, when capacity shrank, an elastic re-form
via :func:`elastic_reform`.

The JAX package reads the backoff's defaults from
RAY_TPU_RESTART_BACKOFF_BASE_S / _MAX_S; the port reads no environment
variable: the defaults below are that flag table's (1.0 s, 30.0 s), and
`train.trainer.TorchTrainer` takes them as constructor arguments.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

RESTART_BACKOFF_BASE_S = 1.0
RESTART_BACKOFF_MAX_S = 30.0


def backoff_delay(attempt: int, base_s: float = RESTART_BACKOFF_BASE_S,
                  cap_s: float = RESTART_BACKOFF_MAX_S,
                  jitter_frac: float = 0.25, rand=random.random) -> float:
    """Exponential backoff with jitter for restart attempt `attempt`
    (1-based): min(cap, base * 2**(attempt-1)) * (1 + jitter*U[0,1))."""
    attempt = max(1, int(attempt))
    delay = min(float(cap_s), float(base_s) * (2.0 ** (attempt - 1)))
    return delay * (1.0 + max(0.0, jitter_frac) * rand())


def elastic_reform(scaling, sharding, available_workers: int
                   ) -> Optional[Tuple[Any, Any]]:
    """Shrink a gang to fit reduced capacity, or None when no valid
    smaller shape exists.

    Only active when ``ScalingConfig.min_workers`` is set. Multi-slice
    gangs shrink by whole slices (the workers per slice are the slice's
    mesh and must not change), and a ``ShardingConfig`` whose ``dcn_dp``
    equals the slice count follows it down (dcn_dp 1 is a flat mesh).
    Flat gangs shrink to exactly the available worker count. Returns
    (new_scaling, new_sharding)."""
    floor = getattr(scaling, "min_workers", None)
    n = scaling.num_workers
    if floor is None or available_workers >= n or n <= 1:
        return None
    slices = max(1, getattr(scaling, "num_slices", 1))
    if slices > 1:
        per_slice = n // slices
        new_slices = available_workers // per_slice
        new_n = new_slices * per_slice
    else:
        new_n = available_workers
        new_slices = 1
    if new_n < max(1, int(floor)) or new_n <= 0:
        return None
    new_scaling = dataclasses.replace(scaling, num_workers=new_n,
                                      num_slices=new_slices)
    new_sharding = sharding
    if sharding is not None and slices > 1 and \
            getattr(sharding, "dcn_dp", 1) == slices:
        new_sharding = dataclasses.replace(sharding, dcn_dp=new_slices)
    return new_scaling, new_sharding


class GangSupervisor:
    """Context manager watching one gang's actors for peer death.

    On the first DEAD member: records the failure (cause and host) in
    the conductor's resilience log and kills every surviving member, so
    the driver's blocking ``get`` fails fast instead of waiting out a
    wedged collective. The kills go through ``kill_actor`` and are
    expected deaths: only the original casualty charges the failure
    domain tracker.
    """

    def __init__(self, handles: List[Any], run_id: str = ""):
        self.run_id = run_id
        self._handles: Dict[str, Any] = {h.actor_id: h for h in handles}
        self._worker = None
        self._lock = threading.Lock()
        self.first_death: Optional[Dict[str, Any]] = None

    def __enter__(self) -> "GangSupervisor":
        from .._private import worker as worker_mod

        self._worker = worker_mod.global_worker
        if self._worker is not None:
            self._worker.subscribe_channel("actor_state", self._on_state)
        return self

    def __exit__(self, *exc) -> None:
        if self._worker is not None:
            self._worker.unsubscribe_channel("actor_state", self._on_state)
        return None

    def _on_state(self, msg: Any) -> None:
        if not isinstance(msg, dict) or msg.get("state") != "DEAD":
            return
        actor_id = msg.get("actor_id")
        if actor_id not in self._handles:
            return
        with self._lock:
            if self.first_death is not None:
                return  # the survivors killed below publish DEAD too
            self.first_death = {"actor_id": actor_id, "ts": time.time()}
        # off the pubsub dispatch thread: the cause lookup and the kills
        # are conductor calls of their own
        threading.Thread(target=self._handle_death, args=(actor_id,),
                         name="gang-supervisor", daemon=True).start()

    def _handle_death(self, actor_id: str) -> None:
        w = self._worker
        if w is None:
            return
        cause = ""
        try:
            info = w.conductor.call("get_actor_info", actor_id, timeout=5.0)
            cause = (info or {}).get("death_cause") or ""
        except Exception:  # noqa: BLE001 — conductor mid-restart
            pass
        with self._lock:
            if self.first_death is not None:
                self.first_death["cause"] = cause
        try:
            w.conductor.call("report_resilience_event", {
                "kind": "gang_peer_death", "run_id": self.run_id,
                "actor_id": actor_id, "detail": cause}, timeout=5.0)
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        for aid in self._handles:
            if aid == actor_id:
                continue
            try:
                w.conductor.call("kill_actor", aid, True, timeout=10.0)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
