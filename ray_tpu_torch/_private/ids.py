"""Identifiers for objects, tasks, actors, jobs, nodes, placement groups.

The same ids as the JAX package's: an analog of the reference's binary ID
scheme (src/ray/common/id.h) with the same *semantic* structure — IDs embed
ownership/lineage hints — but a simple 16-byte random payload plus a type tag
instead of the reference's bit-packed lineage indices: lineage lives in the
owner's table instead (`Worker._lineage` in worker.py).
"""
from __future__ import annotations

import os
import threading

_counter_lock = threading.Lock()
_counter = 0


def _rand_hex(n: int = 16) -> str:
    return os.urandom(n).hex()


class BaseID:
    __slots__ = ("_hex",)
    _prefix = "id"

    def __init__(self, hex_id: str | None = None):
        self._hex = hex_id if hex_id is not None else _rand_hex()

    @classmethod
    def from_hex(cls, hex_id: str) -> "BaseID":
        return cls(hex_id)

    def hex(self) -> str:
        return self._hex

    def binary(self) -> bytes:
        return bytes.fromhex(self._hex)

    def __hash__(self):
        return hash((self._prefix, self._hex))

    def __eq__(self, other):
        return type(other) is type(self) and other._hex == self._hex

    def __repr__(self):
        return f"{type(self).__name__}({self._hex[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._hex,))


class JobID(BaseID):
    _prefix = "job"


class NodeID(BaseID):
    _prefix = "node"


class TaskID(BaseID):
    _prefix = "task"


class ActorID(BaseID):
    _prefix = "actor"


class ObjectID(BaseID):
    _prefix = "object"


class PlacementGroupID(BaseID):
    _prefix = "pg"


class WorkerID(BaseID):
    _prefix = "worker"


def next_seqno() -> int:
    """Process-wide monotonically increasing sequence number."""
    global _counter
    with _counter_lock:
        _counter += 1
        return _counter
