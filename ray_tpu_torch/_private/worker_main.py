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

    w = Worker(mode="worker", conductor_address=(host, int(port)),
               session_dir=session_dir, worker_id=worker_id)
    worker_mod.global_worker = w
    gpus = _bound_gpus()
    w.conductor.call("register_worker", worker_id, w.address, os.getpid(),
                     node_id, gpus, timeout=30.0)

    def _term(signum, frame):
        os._exit(0)

    signal.signal(signal.SIGTERM, _term)

    # Park the main thread; all work arrives via the RPC server. Re-register
    # periodically (idempotent; the reconnecting client re-dials
    # underneath). Exit after a sustained outage: the cluster is gone.
    grace = config.worker_orphan_grace
    last_ok = time.monotonic()
    while True:
        # chunked: in fork-server children the kernel often delivers
        # SIGTERM to a non-main thread, which only sets CPython's signal
        # flag — the main thread notices at its next bytecode
        for _ in range(min(50, max(1, int(grace * 10)))):
            time.sleep(0.1)
        try:
            ok = w.conductor.call(
                "register_worker", worker_id, w.address, os.getpid(),
                node_id, gpus, timeout=5.0)
            if ok is False:
                # the conductor wrote this worker off (its GPUs may be
                # leased to another process): it must not run on
                os._exit(0)
            last_ok = time.monotonic()
        except Exception:  # noqa: BLE001 — conductor unreachable
            if time.monotonic() - last_ok > grace:
                os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
