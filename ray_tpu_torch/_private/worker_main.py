"""Worker process entrypoint — analog of the reference's
python/ray/_private/workers/default_worker.py (parse addresses, connect,
run the task loop :254,:289). Spawned by the conductor's worker pool,
forked from the template or started cold
(`python -m ray_tpu_torch._private.worker_main`)."""
from __future__ import annotations

import os
import pickle
import signal
import sys
import time

from .worker_spawn import (ENV_CONDUCTOR, ENV_DRIVER_SYS_PATH,
                           ENV_GPU_INDICES, ENV_NODE_ID, ENV_SESSION_DIR,
                           ENV_SYSTEM_CONFIG, ENV_WORKER_ID)


def _bound_gpus():
    """The pool's indices of the GPUs this process was leased at spawn
    (its CUDA_VISIBLE_DEVICES names them by the driver's ids); announced
    on every registration."""
    spec = os.environ.get(ENV_GPU_INDICES, "")
    try:
        gpus = tuple(int(c) for c in spec.split(",") if c.strip() != "")
    except ValueError:
        return None
    return gpus or None


def reregister_until_orphaned(register, grace: float,
                              sleep=time.sleep, clock=time.monotonic) -> None:
    """Re-register every period (idempotent; the reconnecting client
    re-dials underneath) and return when the worker must exit: the
    conductor answered False (it wrote this worker off, and its GPUs may
    be leased to another process), or the outage lasted `grace`, counted
    from the first failed call. Counted from the last success instead,
    one failed call a full period later (the first call on a connection
    a restarted conductor dropped) ended a worker whose period is its
    grace."""
    period = min(50, max(1, int(grace * 10)))
    failing_since = None
    while True:
        # chunked: in fork-server children the kernel often delivers
        # SIGTERM to a non-main thread, which only sets CPython's signal
        # flag — the main thread notices at its next bytecode
        for _ in range(1 if failing_since is not None else period):
            sleep(0.1)
        try:
            if register() is False:
                return
            failing_since = None
        except Exception:  # noqa: BLE001 — conductor unreachable
            now = clock()
            if failing_since is None:
                failing_since = now
            elif now - failing_since > grace:
                return


def main() -> None:
    from .config import config

    if os.environ.get(ENV_SYSTEM_CONFIG):
        # cold start: the flag table comes from the session's file (a
        # forked worker got it in the template's request)
        with open(os.environ[ENV_SYSTEM_CONFIG], "rb") as f:
            config.load(pickle.load(f))
    # Driver sys.path propagation: functions/classes pickled by reference
    # (module-level defs) must be importable here — the analog of the
    # reference's working_dir/py_modules runtime-env exposure.
    extra = os.environ.get(ENV_DRIVER_SYS_PATH, "")
    for p in reversed([p for p in extra.split(os.pathsep) if p]):
        if p not in sys.path:
            sys.path.insert(0, p)

    conductor = os.environ[ENV_CONDUCTOR]
    worker_id = os.environ[ENV_WORKER_ID]
    session_dir = os.environ[ENV_SESSION_DIR]
    node_id = os.environ.get(ENV_NODE_ID)
    host, port = conductor.rsplit(":", 1)
    if config.worker_verbose:
        print(f"[worker {worker_id[:8]}] connecting to conductor "
              f"{host}:{port}", flush=True)

    from . import worker as worker_mod
    from .worker import Worker

    worker_mod.stamp_startup("main")
    if os.environ.get(ENV_GPU_INDICES):
        # a GPU worker's actor needs torch: imported here, on the main
        # thread before the worker's threads start, it loads in a fresh
        # interpreter's time; imported by the actor's unpickling on an
        # RPC thread, it took up to twice that on the card's host
        import torch  # noqa: F401

        worker_mod.stamp_startup("torch_imported")
    w = Worker(mode="worker", conductor_address=(host, int(port)),
               session_dir=session_dir, worker_id=worker_id)
    worker_mod.global_worker = w
    gpus = _bound_gpus()
    w.conductor.call("register_worker", worker_id, w.address, os.getpid(),
                     node_id, gpus, timeout=30.0)
    worker_mod.stamp_startup("registered")

    def _term(signum, frame):
        os._exit(0)

    signal.signal(signal.SIGTERM, _term)

    # Park the main thread; all work arrives via the RPC server.
    reregister_until_orphaned(
        lambda: w.conductor.call("register_worker", worker_id, w.address,
                                 os.getpid(), node_id, gpus, timeout=5.0),
        config.worker_orphan_grace)
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
