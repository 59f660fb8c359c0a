"""Runtime flag table — the one place to see and override every knob.

Analog of the reference's `src/ray/common/ray_config_def.h` and the
`_system_config` dict accepted by ray.init, with the JAX package's flags
of the ported subsystems by the same name, type and default. The port
reads no environment variable for them: a value resolves as

    explicit _system_config override  >  default

and reaches the processes a cluster spawns through the spawn itself
(the fork template's request, or a file in the session directory for a
cold spawn), never through the environment.

Flags of the JAX package with no counterpart here, so that setting one
raises as an unknown flag instead of doing nothing:
- `chips`: overrode the detected TPU chip count; the port counts the
  GPUs the driver sees (`torch.cuda.device_count()`), and
  `init(resources={"GPU": n})` sets the count explicitly.
- `pallas_interpret`: ran Pallas kernels in interpret mode; the port
  has no Pallas kernel (its CPU path is the kernels' plain versions).
- the flags of subsystems not ported yet, each back with the slice
  that reads it: `node_ip` (the gang code of ROADMAP Queue 1 item 3),
  Dataset backpressure (`data_memory_budget`, `data_shm_high_water`),
  the weight fabric (`weights_keep`, `weights_publish_ttl_s`),
  workflows (`workflow_storage`), and the trainer's restart backoff
  (`restart_backoff_base_s`, `restart_backoff_max_s`), which the
  port's trainer takes as arguments.

The cluster layer's flags (remote nodes and their heartbeats,
persistence, the memory and log monitors, the failure-domain tracker
and the preemption watcher) are the JAX package's by name, type and
default. A node agent takes the head's resolved table when it joins
(`session_info`), so a flag set on the head holds on every node.

Flags the port adds, each in place of an environment variable the JAX
package reads: `rpc_warn_ms` (RAY_TPU_RPC_WARN_MS), `no_fork_server`
(RAY_TPU_NO_FORK_SERVER) and `worker_verbose` (RAY_TPU_WORKER_VERBOSE).
`force_remote_fetch` was a flag already.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List


@dataclass(frozen=True)
class Flag:
    name: str            # lower_snake
    type: type
    default: Any
    doc: str


_FLAGS: List[Flag] = [
    # --- control plane -------------------------------------------------
    Flag("worker_start_timeout", float, 60.0,
         "seconds a lease waits for a worker process to start"),
    Flag("node_timeout", float, 10.0,
         "seconds without a heartbeat before an agent node is dead"),
    Flag("node_heartbeat", float, 1.0,
         "node agent heartbeat period (seconds)"),
    Flag("worker_orphan_grace", float, 30.0,
         "seconds a worker outlives a dead conductor before exiting"),
    Flag("node_orphan_grace", float, 30.0,
         "seconds a node agent outlives a dead conductor before exiting"),
    Flag("restore_grace", float, 20.0,
         "seconds a snapshot-restored worker record is presumed alive "
         "awaiting its re-register"),
    Flag("lease_idle_ttl", float, 0.1,
         "seconds a submitter keeps an idle worker lease for reuse "
         "before returning it to the conductor (reference: direct task "
         "submitter worker-lease caching)"),
    Flag("rpc_warn_ms", float, 5000.0,
         "control-plane RPC handlers slower than this many milliseconds "
         "print a warning"),
    Flag("no_fork_server", int, 0,
         "1 = spawn every worker cold instead of forking it from the "
         "pre-warmed template"),
    Flag("worker_verbose", int, 0,
         "1 = each worker prints a line when it connects"),
    # --- object plane --------------------------------------------------
    Flag("object_store_cap", int, 2 * 1024**3,
         "per-process object store memory cap in bytes; eviction spills "
         "past it"),
    Flag("shm_threshold", int, 100 * 1024,
         "bytes above which host objects go to shared memory"),
    Flag("arena_size", int, 2 * 1024**3,
         "native shm arena size in bytes"),
    Flag("native_store", int, 1,
         "1 = use the C++ slab arena (shm_store.cc), and fail if it does "
         "not build; 0 = per-object SharedMemory segments"),
    Flag("fetch_chunk", int, 64 * 1024 * 1024,
         "chunk size for cross-host object pulls"),
    Flag("spill_dir", str, "",
         "directory for eviction spill files (default: tmp)"),
    Flag("force_remote_fetch", int, 0,
         "testing: every process claims a distinct machine id, forcing "
         "the cross-host chunked fetch path"),
    # --- monitors ------------------------------------------------------
    Flag("memory_usage_threshold", float, 0.95,
         "node memory fraction above which the monitor OOM-kills the "
         "greediest worker (<= 0 disables; reference memory_monitor.h)"),
    Flag("memory_monitor_refresh_ms", int, 250,
         "memory monitor poll period in milliseconds (0 disables)"),
    Flag("log_to_driver", int, 1,
         "1 = mirror worker stdout/stderr lines to the driver console "
         "via the worker_logs pubsub channel (reference log_monitor.py)"),
    # --- resilience ----------------------------------------------------
    Flag("preempt_grace_s", float, 30.0,
         "default preemption grace window (seconds) when the "
         "maintenance-event channel does not specify one"),
    Flag("maintenance_poll_s", float, 1.0,
         "poll period of the maintenance-event file watcher"),
    Flag("quarantine_threshold", float, 3.0,
         "decayed failure score at which a host is quarantined out of "
         "lease grants and gang formation"),
    Flag("quarantine_halflife_s", float, 600.0,
         "half-life (seconds) of a host's failure score decay"),
]

_BY_NAME: Dict[str, Flag] = {f.name: f for f in _FLAGS}


def _coerce(flag: Flag, raw: Any) -> Any:
    if isinstance(raw, str) and flag.type is not str:
        return flag.type(float(raw)) if flag.type is int else flag.type(raw)
    return flag.type(raw)


def _flag(name: str) -> Flag:
    flag = _BY_NAME.get(name)
    if flag is None:
        raise KeyError(f"unknown config flag {name!r}; known: "
                       f"{sorted(_BY_NAME)}")
    return flag


class RayTpuConfig:
    """Resolved view of every flag: `_system_config` overrides installed
    by `apply` (or `load` in a spawned process), else the default."""

    def __init__(self):
        self._overrides: Dict[str, Any] = {}

    def get(self, name: str) -> Any:
        flag = _flag(name)
        return self._overrides.get(name, flag.default)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    def apply(self, overrides: Dict[str, Any]) -> Dict[str, Any]:
        """Validate and install `_system_config` overrides. Returns the
        prior override table for `restore`: a cluster's overrides must
        die with it, not govern the next cluster in this process."""
        coerced = {}
        for name, value in overrides.items():
            if name not in _BY_NAME:
                raise ValueError(
                    f"unknown _system_config flag {name!r}; known flags: "
                    f"{sorted(_BY_NAME)}")
            coerced[name] = _coerce(_BY_NAME[name], value)
        prior = dict(self._overrides)
        self._overrides.update(coerced)
        return prior

    def restore(self, prior: Dict[str, Any]) -> None:
        """Undo an `apply` using its returned token."""
        self._overrides = dict(prior)

    def snapshot(self) -> Dict[str, Any]:
        """The overrides in force, as a spawned process receives them."""
        return dict(self._overrides)

    def load(self, overrides: Dict[str, Any]) -> None:
        """Install a parent's `snapshot` in a spawned process."""
        self._overrides = {}
        self.apply(overrides)

    def describe(self) -> List[Dict[str, Any]]:
        """All flags with their current value and provenance."""
        return [{"name": f.name, "type": f.type.__name__,
                 "default": f.default, "value": self.get(f.name),
                 "source": ("system_config" if f.name in self._overrides
                            else "default"),
                 "doc": f.doc}
                for f in _FLAGS]


config = RayTpuConfig()
