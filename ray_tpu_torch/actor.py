"""Actor API — analog of the reference's python/ray/actor.py (ActorClass
._remote :275,:851; ActorHandle; ActorMethod). Creation is conductor-mediated
(reference gcs_actor_manager.cc); steady-state method calls go directly to the
actor's worker with per-caller sequence numbers for ordering. An actor
class asks for GPUs with `num_gpus=`: with whole GPUs its worker is
spawned bound to them."""
from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, Optional

from . import exceptions as exc
from ._private import worker as worker_mod
from .remote_function import (DAG_NOT_PORTED, check_options,
                              placement_group_id, resources_of)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs,
                                    num_returns=self._num_returns())

    def options(self, num_returns: int = 1):
        m = ActorMethod(self._handle, self._name)
        m._override_num_returns = num_returns
        return m

    def bind(self, *args, **kwargs):
        raise NotImplementedError(DAG_NOT_PORTED)

    def _num_returns(self) -> int:
        return getattr(self, "_override_num_returns", 1)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name} cannot be called directly; use "
            f".{self._name}.remote(...)")


class ActorHandle:
    """Client-side handle. Each handle keeps its own monotonically increasing
    sequence number so the server can execute this caller's requests in
    submission order (reference sequential_actor_submit_queue.cc)."""

    def __init__(self, actor_id: str, address, max_task_retries: int = 0):
        self._actor_id = actor_id
        self._address = tuple(address) if address else None
        self._max_task_retries = max_task_retries
        self._caller_id = uuid.uuid4().hex
        self._seqno = 0
        self._lock = threading.Lock()

    @property
    def actor_id(self) -> str:
        return self._actor_id

    def _invoke(self, method: str, args, kwargs, num_returns: int = 1):
        w = worker_mod.global_worker
        if w is None:
            raise RuntimeError("ray_tpu_torch.init() must be called first")
        with self._lock:
            seqno = self._seqno
            self._seqno += 1
        return w.submit_actor_task(
            self._actor_id, self._address, method, args, kwargs,
            num_returns, seqno, self._caller_id,
            max_task_retries=self._max_task_retries)

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):
        return (ActorHandle,
                (self._actor_id, self._address, self._max_task_retries))

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:12]}…)"


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        check_options(self._options)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote(...)")

    def options(self, **overrides) -> "ActorClass":
        opts = dict(self._options)
        opts.update(overrides)
        return ActorClass(self._cls, opts)

    def remote(self, *args, **kwargs) -> ActorHandle:
        w = worker_mod.global_worker
        if w is None:
            raise RuntimeError("ray_tpu_torch.init() must be called first")
        o = dict(self._options)
        # num_cpus stays an option of its own: an actor's CPU default is
        # 0 while it runs (Worker.create_actor)
        o["resources"] = {k: v for k, v in resources_of(o).items()
                          if k != "CPU"}
        o.pop("num_gpus", None)
        o["placement_group_id"] = placement_group_id(o)
        o.pop("placement_group", None)
        info = w.create_actor(self._cls, args, kwargs, o)
        return ActorHandle(info["actor_id"], info["address"],
                           max_task_retries=o.get("max_task_retries", 0))

    @property
    def underlying_class(self):
        return self._cls


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    info = w.conductor.call("get_actor_info", None, name, namespace, 30.0,
                            timeout=60.0)
    if info["state"] == "DEAD":
        raise exc.ActorDiedError(info["actor_id"],
                                 info.get("death_cause") or "")
    if info["address"] is None:
        raise exc.ActorUnavailableError(
            info["actor_id"], f"actor {name!r} not placed within timeout "
            f"(state={info['state']})")
    return ActorHandle(info["actor_id"], info["address"],
                       max_task_retries=info.get("max_task_retries", 0))


def exit_actor() -> None:
    """Terminate the current actor gracefully after the in-flight call
    completes (reference: ray.actor.exit_actor / __ray_terminate__)."""
    raise SystemExit(0)
