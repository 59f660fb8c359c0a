"""Device profiling: torch.profiler wired into the cluster runtime (the
port's counterpart of the JAX package's util/profiling.py, which wraps
jax.profiler).

Reference surface: the dashboard/CLI profiling endpoints
(python/ray/dashboard worker profiling, `ray timeline`). On the card the
interesting profile is the DEVICE trace: torch.profiler records CPU ops
and, through CUPTI, every CUDA kernel the process launches, captured
either in-process or remotely on any worker/actor via the worker RPC
plane. Traces land in the session dir (`{session}/profiles/<tag>`) as
one `*.pt.trace.json` (chrome trace: Perfetto, chrome://tracing,
TensorBoard's profile plugin).

Driver-side:
    with ray_tpu_torch.util.profiling.profile("step10"):   # in-process
        train_step(...)
    ray_tpu_torch.util.profiling.profile_actor(handle, seconds=5)  # remote
Annotations: `annotate("fwd")` marks a region on the trace timeline
(torch.profiler.record_function).

Activities default to CPU + CUDA. A process without CUDA raises unless
the caller passes `device="cpu"` (CPU ops only), and so does one whose
torch.profiler cannot trace CUDA (no CUPTI): a CPU-only trace never
stands in for a device trace. The profiler is owned by one thread of its
own, which starts and stops it (torch.profiler must be stopped on the
thread that started it), so `start_profile` and `stop_profile` may come
from any threads, as a worker's RPC handlers do; it records the ops of
every thread of the process where torch offers that.

The device memory snapshot is torch's allocator snapshot
(`torch.cuda.memory._dump_snapshot`): a pickle, where the JAX package
writes pprof.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Optional

TRACE_SUFFIX = ".pt.trace.json"

_lock = threading.Lock()
_active: Optional["_Session"] = None


def _default_dir(tag: Optional[str]) -> str:
    from .. import session_root
    from .._private.worker import global_worker

    base = getattr(global_worker, "session_dir", None) or session_root()
    tag = tag or time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(base, "profiles", tag)


def _activities(device: Optional[str]) -> list:
    import torch
    from torch.profiler import ProfilerActivity

    if device == "cpu":
        return [ProfilerActivity.CPU]
    if device not in (None, "cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device in this process: a device profile needs one "
            "(pass device='cpu' for a trace of CPU ops only)")
    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError(
            "torch.profiler cannot trace CUDA here (no CUPTI): a device "
            "profile would hold no kernel")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _all_threads_config():
    """Record every thread's ops, where this torch can."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class _Session:
    """One running profile, owned by a thread of its own."""

    def __init__(self, log_dir: str, activities: list):
        self.log_dir = log_dir
        self.path = os.path.join(
            log_dir, f"{os.path.basename(log_dir) or 'trace'}"
            f"-{os.getpid()}{TRACE_SUFFIX}")
        self._activities = activities
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-profile")

    def _run(self) -> None:
        from torch.profiler import profile as torch_profile

        try:
            kw: Dict[str, Any] = {"activities": self._activities}
            config = _all_threads_config()
            if config is not None:
                kw["experimental_config"] = config
            prof = torch_profile(**kw)
            prof.start()
        except BaseException as e:  # noqa: BLE001 — handed to start()
            self._error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            prof.export_chrome_trace(self.path)
        except BaseException as e:  # noqa: BLE001 — handed to stop()
            self._error = e

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            raise self._error

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise self._error


def start_profile(tag: Optional[str] = None,
                  log_dir: Optional[str] = None,
                  device: Optional[str] = None) -> str:
    """Begin a torch.profiler trace; returns the trace directory."""
    global _active
    with _lock:
        if _active is not None:
            raise RuntimeError(
                f"profile already running into {_active.log_dir}")
        activities = _activities(device)
        d = log_dir or _default_dir(tag)
        os.makedirs(d, exist_ok=True)
        session = _Session(d, activities)
        session.start()
        _active = session
        return d


def stop_profile() -> str:
    """End the running trace and write it; returns its directory."""
    global _active
    with _lock:
        if _active is None:
            raise RuntimeError("no profile running")
        session, _active = _active, None
    session.stop()
    return session.log_dir


@contextlib.contextmanager
def profile(tag: Optional[str] = None, log_dir: Optional[str] = None,
            device: Optional[str] = None):
    """Context-managed device trace around a block of work."""
    d = start_profile(tag, log_dir, device)
    try:
        yield d
    finally:
        stop_profile()


def annotate(name: str):
    """Named region on the profiler timeline (record_function)."""
    import torch

    return torch.profiler.record_function(name)


def trace_files(d: str) -> list:
    """The chrome-trace files a profile wrote into directory `d`."""
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(TRACE_SUFFIX))


def record_memory_history(max_entries: int = 100_000) -> None:
    """Start recording the CUDA allocator's history (the stack of each
    allocation), which `save_device_memory_profile` then holds."""
    import torch

    torch.cuda.memory._record_memory_history(max_entries=max_entries)


def save_device_memory_profile(path: Optional[str] = None) -> str:
    """Snapshot the CUDA allocator (segments, blocks and, after
    `record_memory_history`, each allocation's stack) as a pickle —
    torch's memory-leak hunting tool (pytorch.org/memory_viz), surfaced
    next to the traces."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device in this process: nothing to "
                           "snapshot")
    if path is None:
        path = os.path.join(_default_dir(None) + "-memory", "memory.pickle")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.memory._dump_snapshot(path)
    return path


# ------------------------------------------------------ remote profiling


def profile_actor(actor, seconds: float = 5.0,
                  tag: Optional[str] = None,
                  device: Optional[str] = None) -> str:
    """Capture a device trace ON the actor's worker process for
    `seconds` while it keeps serving calls; returns the trace dir path
    on that worker's host. The actor's CUDA kernels during the window
    show up in the trace (reference: dashboard worker profiling, but
    device-level)."""
    from .._private.worker import global_worker

    addr = getattr(actor, "_address", None)
    if addr is None:
        raise TypeError("profile_actor expects an ActorHandle")
    tag = tag or f"actor-{time.strftime('%H%M%S')}"
    client = global_worker.clients.get(tuple(addr))
    d = client.call("start_device_profile", tag, device, timeout=30.0)
    try:
        time.sleep(seconds)
        return client.call("stop_device_profile", timeout=120.0) or d
    except BaseException:
        # never leave the remote worker tracing forever (unbounded trace
        # growth + every later profile rejected)
        try:
            client.notify("stop_device_profile")
        except Exception:  # noqa: BLE001 — worker may be gone
            pass
        raise


def list_profiles() -> list:
    """Profile trace dirs in this session (driver-local host)."""
    from .._private.worker import global_worker

    base = getattr(global_worker, "session_dir", None)
    if base is None:
        return []
    root = os.path.join(base, "profiles")
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, d) for d in os.listdir(root))
