"""PyTorch/CUDA port of ray_tpu, for the NVIDIA H100.

The JAX package `ray_tpu` is the reference; this package imports nothing
of it and never imports `jax`.

The model stack: GPT-2 and Llama scoring, serving and training, the MoE
decoder, the parallel layer, checkpoints and the trainer, with the
TPU kernels as hand-written Hopper kernels (`csrc/`, bound in
`kernels.py`). Entry points take `device=` and default to "cuda": they
raise when CUDA is unavailable and the caller did not ask for the CPU.
On a CPU tensor each kernel's wrapper runs its plain PyTorch version; on
a CUDA tensor it launches the kernel or raises.

The runtime (this module's API, as `ray_tpu`'s): a cluster of worker
processes with tasks, actors and a shared-memory object store. The head
runs in the driver (`init()`) or on its own (`python -m ray_tpu_torch
start --head`); node agents join it (`start --address HOST:PORT`), each
with its own GPUs; placement groups reserve bundles across nodes
(`util.placement_group`), and jobs run drivers on the head
(`job_submission`).

    import ray_tpu_torch as rt
    rt.init()                      # counts the GPUs this process sees

    @rt.remote(num_gpus=1)
    class Scorer: ...

Importing the package does not import torch: a worker process pays for
torch only when a payload or the user's code needs it.
`resolve_device` comes through the module's `__getattr__`.
"""
from __future__ import annotations

import atexit
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from . import exceptions  # noqa: F401
from ._private import worker as _worker_mod
from ._private.conductor import Conductor
from ._private.object_store import ObjectRef  # noqa: F401
from ._private.worker import Worker
from .actor import ActorClass, ActorHandle, exit_actor, get_actor  # noqa: F401
from .remote_function import RemoteFunction

__version__ = "0.1.0"

_conductor: Optional[Conductor] = None
_system_config_prior: Optional[Dict[str, Any]] = None


def __getattr__(name: str):
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def session_root() -> str:
    """Where the port's session directories live (apart from the JAX
    package's)."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def is_initialized() -> bool:
    return _worker_mod.global_worker is not None


def init(address: Optional[str] = None, *,
         num_cpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: str = "default",
         session_dir: Optional[str] = None,
         worker_env: Optional[Dict[str, str]] = None,
         ignore_reinit_error: bool = False,
         _system_config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Start a local cluster (conductor in this process) or connect to a
    running one with ``address="host:port"``, or ``address="auto"``: the
    address in RTT_ADDRESS. A job's driver (its head sets RTT_ADDRESS)
    connects with a plain ``init()`` too.

    A new cluster counts the GPUs this process sees
    (`torch.cuda.device_count()`, which honours CUDA_VISIBLE_DEVICES)
    as its "GPU" resource, unless ``resources`` names "GPU". Host
    workers run with CUDA_VISIBLE_DEVICES="" and cannot touch a card; a
    whole-GPU lease gets a worker of its own, bound to its GPUs, so
    ``worker_env`` may not set CUDA_VISIBLE_DEVICES.

    ``_system_config`` overrides flags of the table in
    `_private/config.py`; they hold for this cluster and reach its
    workers, and `shutdown()` undoes them."""
    global _conductor, _system_config_prior
    if is_initialized():
        if ignore_reinit_error:
            return {"address": _worker_mod.global_worker.conductor_address}
        raise RuntimeError("ray_tpu_torch.init() already called; "
                           "use ignore_reinit_error=True to ignore")
    from ._private.conductor import ENV_ADDRESS

    if address is not None and address.startswith("ray://"):
        raise NotImplementedError(
            f"init(address={address!r}): the client is not ported yet "
            "(ROADMAP Queue 1 item 2, third part); pass "
            "address='host:port' of a running head")
    if address == "auto":
        # reference semantics of ray.init("auto") / RAY_ADDRESS
        address = os.environ.get(ENV_ADDRESS)
        if not address:
            raise RuntimeError(
                f"init(address='auto'): no {ENV_ADDRESS} in the "
                "environment; pass address='host:port' or start a head "
                "with `python -m ray_tpu_torch start --head`")
    elif address is None:
        # job drivers spawned by the head find their cluster here
        address = os.environ.get(ENV_ADDRESS) or None
    if worker_env and "CUDA_VISIBLE_DEVICES" in worker_env:
        raise ValueError(
            "worker_env may not set CUDA_VISIBLE_DEVICES: host workers see "
            "no GPU, and a GPU reaches a worker only through a lease "
            "(num_gpus=)")
    if _system_config:
        from ._private.config import config as _cfg

        _system_config_prior = _cfg.apply(_system_config)
    if session_dir is None and address is not None:
        # a driver on the head's machine (a job's) shares its session
        session_dir = _head_session_dir(address)
    if session_dir is None:
        import uuid as _uuid

        session_dir = os.path.join(
            session_root(),
            f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
            f"_{_uuid.uuid4().hex[:8]}")
    os.makedirs(session_dir, exist_ok=True)

    if address is None:
        total: Dict[str, float] = dict(resources or {})
        total.setdefault("CPU", float(num_cpus if num_cpus is not None
                                      else (os.cpu_count() or 1)))
        if "GPU" not in total:
            total["GPU"] = float(_detect_gpus())
        import sys as _sys

        from ._private.worker_spawn import ENV_DRIVER_SYS_PATH

        wenv = {"CUDA_VISIBLE_DEVICES": "",
                ENV_DRIVER_SYS_PATH: os.pathsep.join(
                    p for p in _sys.path if p and os.path.isdir(p))}
        wenv.update(worker_env or {})
        _conductor = Conductor(
            total, session_dir, worker_env=wenv,
            gpu_ids=_visible_gpu_ids(int(total.get("GPU", 0)))).start()
        conductor_address = _conductor.address
        # Pre-start workers so first tasks don't pay process cold-start
        # (reference: WorkerPool prestarts language workers, worker_pool.h:156)
        _conductor.handler.prestart_workers(min(int(total.get("CPU", 1)), 4))
    else:
        host, port = address.rsplit(":", 1)
        conductor_address = (host, int(port))

    w = Worker(mode="driver", conductor_address=conductor_address,
               session_dir=session_dir)
    _worker_mod.global_worker = w
    atexit.register(shutdown)
    return {"address": conductor_address, "session_dir": session_dir}


def _head_session_dir(address: str) -> Optional[str]:
    """The head's session directory, when it exists on this machine."""
    from ._private.rpc import RpcClient

    host, port = address.rsplit(":", 1)
    try:
        c = RpcClient((host, int(port)), connect_retries=3)
        try:
            info = c.call("session_info", timeout=10.0)
        finally:
            c.close()
    except Exception:  # noqa: BLE001 — the Worker's connect reports it
        return None
    from ._private.worker import machine_id

    d = info.get("session_dir")
    return d if info.get("machine") == machine_id() and d \
        and os.path.isdir(d) else None


def _detect_gpus() -> int:
    """The GPUs this process sees; creates no CUDA context."""
    import torch

    return torch.cuda.device_count()


def _visible_gpu_ids(n: int) -> List[str]:
    """The driver's id of each of its `n` GPUs, as a worker's
    CUDA_VISIBLE_DEVICES must name them: entries of this process's own
    CUDA_VISIBLE_DEVICES where it is set, else 0..n-1."""
    spec = os.environ.get("CUDA_VISIBLE_DEVICES")
    if spec is None:
        return [str(i) for i in range(n)]
    ids = [s.strip() for s in spec.split(",") if s.strip()]
    if len(ids) < n:
        raise ValueError(f"{n} GPUs asked for but CUDA_VISIBLE_DEVICES "
                         f"names {len(ids)}: {spec!r}")
    return ids[:n]


def shutdown() -> None:
    global _conductor, _system_config_prior
    w = _worker_mod.global_worker
    if w is not None:
        w.shutdown()
        _worker_mod.global_worker = None
    if _conductor is not None:
        _conductor.stop()
        _conductor = None
    # SIGKILL'ed workers cannot unlink their shm arena segments; the
    # conductor's stop() sweeps too — this covers connects to a running
    # head and anything that died since.
    try:
        from ._private.object_store import cleanup_leaked_segments

        cleanup_leaked_segments()
    except OSError:
        pass
    if _system_config_prior is not None:
        from ._private.config import config as _cfg

        _cfg.restore(_system_config_prior)
        _system_config_prior = None


def remote(*args, **kwargs):
    """``@remote`` decorator for functions and classes (reference
    python/ray/_private/worker.py `remote`)."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("remote() takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")

    def wrap(fn_or_cls):
        return _make_remote(fn_or_cls, kwargs)

    return wrap


def _make_remote(fn_or_cls, options: Dict[str, Any]):
    if isinstance(fn_or_cls, type):
        return ActorClass(fn_or_cls, options)
    return RemoteFunction(fn_or_cls, options)


def put(value: Any) -> ObjectRef:
    return _require_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None):
    return _require_worker().get(refs, timeout=timeout)


async def get_async(ref: ObjectRef):
    """Await an ObjectRef from asyncio code without blocking the loop."""
    return await _require_worker().get_async(ref)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    return _require_worker().wait(refs, num_returns=num_returns,
                                  timeout=timeout, fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    w = _require_worker()
    w.conductor.call("kill_actor", actor.actor_id, no_restart, timeout=30.0)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task or actor call producing `ref`.

    Queued work is dropped; running work is interrupted cooperatively
    (force=True kills the executing worker — the guaranteed stop).
    Subsequent get(ref) raises TaskCancelledError. Best-effort like the
    reference: a non-force cancel cannot interrupt native code until it
    re-enters the interpreter."""
    _require_worker().cancel(ref, force=force)


def cluster_resources() -> Dict[str, float]:
    return _require_worker().conductor.call("cluster_resources", timeout=30.0)


def available_resources() -> Dict[str, float]:
    return _require_worker().conductor.call("available_resources",
                                            timeout=30.0)


def nodes() -> List[Dict[str, Any]]:
    return _require_worker().conductor.call("nodes", timeout=30.0)


def _require_worker() -> Worker:
    w = _worker_mod.global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    return w


class _RuntimeContext:
    @property
    def worker_id(self) -> str:
        return _require_worker().worker_id

    @property
    def job_id(self) -> str:
        return _require_worker().job_id

    @property
    def is_driver(self) -> bool:
        return _require_worker().mode == "driver"

    @property
    def actor_id(self) -> Optional[str]:
        rt = _require_worker()._actor_runtime
        return rt.actor_id if rt else None

    def get_actor_handle(self) -> Optional[ActorHandle]:
        w = _require_worker()
        rt = w._actor_runtime
        if rt is None:
            return None
        return ActorHandle(rt.actor_id, w.address)


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "put", "get",
    "get_async", "wait",
    "kill", "cancel", "get_actor", "exit_actor", "cluster_resources",
    "available_resources", "nodes", "get_runtime_context", "ObjectRef",
    "ActorClass", "ActorHandle", "exceptions", "resolve_device",
    "__version__",
]
