"""User-facing exceptions.

Mirrors the surface of the reference's python/ray/exceptions.py (RayTaskError,
RayActorError, WorkerCrashedError, GetTimeoutError, ObjectLostError, ...).
"""
from __future__ import annotations


class RayTpuError(Exception):
    """Base class for framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at `get` with the remote
    traceback attached (reference: RayTaskError.as_instanceof_cause)."""

    def __init__(self, cause: BaseException, remote_traceback: str = "",
                 task_name: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_name = task_name
        super().__init__(
            f"task {task_name or '<unknown>'} failed: "
            f"{type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}")


class ActorError(RayTpuError):
    """The actor died before or during this call."""

    def __init__(self, actor_id: str = "", cause: str = ""):
        self.actor_id = actor_id
        super().__init__(f"actor {actor_id[:12]}… died: {cause}")


class ActorDiedError(ActorError):
    pass


class ActorUnavailableError(ActorError):
    """Actor is restarting; the call may be retried."""


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died (e.g. OOM-killed)."""


class OutOfMemoryError(WorkerCrashedError):
    """The memory monitor killed the worker to protect the node
    (reference: OOM-killed task errors, memory_monitor.h). Subclasses
    WorkerCrashedError so retry semantics match any worker death; the
    final error names the cause with usage numbers."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_id: str = "", msg: str = ""):
        self.object_id = object_id
        super().__init__(f"object {object_id[:12]}… lost{': ' + msg if msg else ''}")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class SchedulingError(RayTpuError):
    """Placement can never be satisfied (e.g. hard NodeAffinity to a dead
    or too-small node) — fails the task instead of waiting forever."""


class PlacementGroupSchedulingError(RayTpuError):
    pass
