"""@remote functions — analog of the reference's
python/ray/remote_function.py (RemoteFunction._remote :266): wrap a callable,
give it `.remote()` returning ObjectRefs, and `.options()` for per-call
overrides. `num_gpus=` asks for GPUs (whole GPUs bind a worker to them;
a fraction only counts the resource); `placement_group=` places the
task in a group's bundles."""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ._private import worker as worker_mod
from ._private.worker import DEFAULT_MAX_RETRIES
from .util import scheduling_strategies as _sched

# options of the JAX package whose machinery is not ported yet
NOT_PORTED_OPTIONS = {
    "runtime_env": "runtime environments are not ported yet (ROADMAP "
                   "Queue 1 item 2, third part)",
    "num_tpus": "the port has no TPUs: ask for GPUs with num_gpus=",
}


DAG_NOT_PORTED = "lazy DAGs are not ported yet (ROADMAP Queue 1 item 8: dag/)"


def check_options(options: Dict[str, Any]) -> None:
    for name, why in NOT_PORTED_OPTIONS.items():
        if options.get(name) is not None:
            raise NotImplementedError(f"{name}=: {why}")


def placement_group_id(options: Dict[str, Any]) -> Optional[str]:
    """The id of the `placement_group=` option (a PlacementGroup or its
    id), or None."""
    pg = options.get("placement_group")
    return getattr(pg, "id", pg) if pg is not None else None


def resources_of(options: Dict[str, Any]) -> Dict[str, float]:
    """The resource request of a function's or actor's options."""
    resources = dict(options.get("resources") or {})
    if options.get("num_cpus") is not None:
        resources["CPU"] = float(options["num_cpus"])
    if options.get("num_gpus") is not None:
        resources["GPU"] = float(options["num_gpus"])
    return resources


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        check_options(self._options)
        # function bytes serialized once per RemoteFunction, not per
        # .remote() call (reference: function table export happens once,
        # function_manager.py)
        self._fn_bytes: Optional[bytes] = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__} cannot be called directly; "
            f"use {self._fn.__name__}.remote(...)")

    def options(self, **overrides) -> "RemoteFunction":
        opts = dict(self._options)
        opts.update(overrides)
        return RemoteFunction(self._fn, opts)

    def remote(self, *args, **kwargs):
        w = worker_mod.global_worker
        if w is None:
            raise RuntimeError("ray_tpu_torch.init() must be called first")
        o = self._options
        if self._fn_bytes is None:
            from ._private import serialization
            self._fn_bytes = serialization.dumps(self._fn)
        return w.submit_task(
            self._fn, args, kwargs,
            fn_bytes=self._fn_bytes,
            name=o.get("name") or self._fn.__name__,
            num_returns=int(o.get("num_returns", 1)),
            resources=resources_of(o),
            max_retries=o.get("max_retries", DEFAULT_MAX_RETRIES),
            placement_group_id=placement_group_id(o),
            scheduling_strategy=_sched.to_wire(
                o.get("scheduling_strategy", "DEFAULT")))

    def bind(self, *args, **kwargs):
        raise NotImplementedError(DAG_NOT_PORTED)

    @property
    def underlying_function(self):
        return self._fn
