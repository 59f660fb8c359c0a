"""Out-of-band collectives between actors and processes (port of the
host plane of ray_tpu/util/collective.py; the reference's
ray.util.collective, python/ray/util/collective/collective.py:120-615).

Small host arrays between worker processes reduce through the
conductor's KV under the `collective` namespace (the reference's
`NCCLUniqueIDStore` named actor, nccl_collective_group.py:28-50,
generalized into the control plane): every rank posts its contribution
under a per-op key, polls for the others and reduces locally. Ops must
be called in the same order on every rank (NCCL's contract). O(n^2)
bytes, by design: bulk tensors belong on the device plane. Arrays go in
and come out as numpy.

The JAX package's device plane, `device_allreduce` (an eager psum over a
mesh axis), waits for ROADMAP Queue 1 item 7; the port's in-program
collectives are `torch.distributed`'s (`parallel/`).
"""
from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ReduceOp(Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_REDUCERS = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
}

_NS = "collective"


def _kv():
    from .runtime import require_worker

    return require_worker("using a collective group").conductor


@dataclass
class _Group:
    name: str
    world_size: int
    rank: int
    op_count: int = 0


_groups: Dict[str, _Group] = {}
_lock = threading.Lock()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "kv",
                          group_name: str = "default") -> None:
    """Imperative init, called by every participating process
    (reference collective.py:120)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if backend not in ("kv", "auto"):
        raise ValueError(f"unsupported backend {backend!r}; host-plane "
                         "groups use 'kv' (device plane needs no group)")
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
        _groups[group_name] = _Group(group_name, world_size, rank)
    # rendezvous: everyone checks in before the group is usable
    _post(group_name, "init", 0, rank, b"")
    _collect(group_name, "init", 0, world_size)


def create_collective_group(actors: Sequence[Any], world_size: int,
                            ranks: Sequence[int], backend: str = "kv",
                            group_name: str = "default") -> List[Any]:
    """Declarative init on a set of actor handles (reference
    collective.py:151): tells each actor to init_collective_group.
    Every actor answers the worker's built-in hook
    ``__ray_tpu_col_init__``, whatever its class."""
    from ..actor import ActorMethod

    if len(actors) != len(ranks):
        raise ValueError(f"{len(actors)} actors but {len(ranks)} ranks")
    if sorted(ranks) != list(range(world_size)):
        raise ValueError(
            f"ranks {sorted(ranks)} must cover 0..{world_size - 1} exactly")
    refs = []
    for actor, rank in zip(actors, ranks):
        refs.append(ActorMethod(actor, "__ray_tpu_col_init__").remote(
            world_size, rank, backend, group_name))
    from .. import get

    return get(refs)


def destroy_collective_group(group_name: str = "default") -> None:
    """Collective teardown. Two closing barriers ensure every rank has
    finished all prior ops before any key deletion (deleting peers' keys
    while they are mid-collect would strand them until timeout); each
    rank then deletes only its own contributions. The final barrier's
    tiny b"" markers are deliberately leaked."""
    g = _groups.get(group_name)
    if g is None:
        return
    try:
        barrier(group_name)
        final_op = g.op_count  # the 2nd barrier's op_id
        barrier(group_name)
        for key in _kv().call("kv_keys", f"col/{group_name}/".encode(),
                              _NS, timeout=30.0):
            tail = key.rsplit(b"/", 1)[-1]
            parts = key.split(b"/")
            own = tail == str(g.rank).encode()
            is_final_barrier = (len(parts) > 2
                                and parts[2] == f"{final_op:08d}".encode())
            if own and not is_final_barrier:
                _kv().call("kv_del", key, _NS, timeout=30.0)
    finally:
        with _lock:
            _groups.pop(group_name, None)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def _get(group_name: str) -> _Group:
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(f"collective group {group_name!r} not "
                           "initialized; call init_collective_group first")
    return g


def _key(group: str, op: str, op_id: int, rank: int) -> bytes:
    return f"col/{group}/{op_id:08d}/{op}/{rank}".encode()


def _post(group: str, op: str, op_id: int, rank: int, payload: bytes) -> None:
    _kv().call("kv_put", _key(group, op, op_id, rank), payload, True, _NS,
               timeout=60.0)


def _collect(group: str, op: str, op_id: int, world_size: int,
             timeout: float = 120.0) -> List[bytes]:
    """Poll the KV until all world_size contributions for this op exist."""
    kv = _kv()
    deadline = time.monotonic() + timeout
    out: List[Optional[bytes]] = [None] * world_size
    missing = set(range(world_size))
    delay = 0.001
    while missing:
        for r in list(missing):
            v = kv.call("kv_get", _key(group, op, op_id, r), _NS,
                        timeout=60.0)
            if v is not None:
                out[r] = v
                missing.discard(r)
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"collective {op} op_id={op_id} in group {group!r} timed "
                f"out waiting for ranks {sorted(missing)}")
        time.sleep(delay)
        delay = min(delay * 2, 0.05)
    return out  # type: ignore[return-value]


def _advance(g: _Group, op: str) -> int:
    """Bump the per-group op counter and garbage-collect this rank's key
    from op_id-2 (safe: any rank starting op k has read all keys of k-1,
    which implies every rank finished k-2)."""
    op_id = g.op_count
    g.op_count += 1
    if op_id >= 2:
        for key in _kv().call(
                "kv_keys", f"col/{g.name}/{op_id - 2:08d}/".encode(),
                _NS, timeout=30.0):
            if key.endswith(f"/{g.rank}".encode()):
                _kv().call("kv_del", key, _NS, timeout=30.0)
    return op_id


def allreduce(tensor: np.ndarray, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM) -> np.ndarray:
    """All ranks contribute, all receive the reduction
    (reference collective.py:258). Returns the reduced array (also copies
    into `tensor` in place when it is a writable ndarray, matching the
    reference's in-place semantics)."""
    g = _get(group_name)
    op_id = _advance(g, "allreduce")
    arr = np.asarray(tensor)
    _post(g.name, "allreduce", op_id, g.rank, _dumps(arr))
    parts = [_loads(b) for b in
             _collect(g.name, "allreduce", op_id, g.world_size)]
    result = _REDUCERS[op](np.stack(parts)).astype(arr.dtype)
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable \
            and tensor.shape == result.shape:
        tensor[...] = result
    return result


def barrier(group_name: str = "default") -> None:
    """reference collective.py:298."""
    g = _get(group_name)
    op_id = _advance(g, "barrier")
    _post(g.name, "barrier", op_id, g.rank, b"")
    _collect(g.name, "barrier", op_id, g.world_size)


def broadcast(tensor: np.ndarray, src_rank: int = 0,
              group_name: str = "default") -> np.ndarray:
    """reference collective.py:373."""
    g = _get(group_name)
    op_id = _advance(g, "broadcast")
    if g.rank == src_rank:
        _post(g.name, "broadcast", op_id, src_rank, _dumps(np.asarray(tensor)))
        result = np.asarray(tensor)
    else:
        kv = _kv()
        deadline = time.monotonic() + 120.0
        while True:
            v = kv.call("kv_get", _key(g.name, "broadcast", op_id, src_rank),
                        _NS, timeout=60.0)
            if v is not None:
                result = _loads(v)
                break
            if time.monotonic() > deadline:
                raise TimeoutError("broadcast timed out")
            time.sleep(0.002)
    # completion marker so src's key can be GC'd by the op-window rule
    _post(g.name, "broadcast_ack", op_id, g.rank, b"")
    _collect(g.name, "broadcast_ack", op_id, g.world_size)
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable \
            and tensor.shape == result.shape and g.rank != src_rank:
        tensor[...] = result
    return result


def allgather(tensor: np.ndarray,
              group_name: str = "default") -> List[np.ndarray]:
    """Returns [rank0_tensor, rank1_tensor, ...] (reference
    collective.py:423)."""
    g = _get(group_name)
    op_id = _advance(g, "allgather")
    _post(g.name, "allgather", op_id, g.rank, _dumps(np.asarray(tensor)))
    return [_loads(b) for b in
            _collect(g.name, "allgather", op_id, g.world_size)]


def reducescatter(tensor: np.ndarray, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM) -> np.ndarray:
    """Reduce across ranks, scatter equal chunks: rank r receives chunk r
    of the reduction (reference collective.py:472)."""
    g = _get(group_name)
    arr = np.asarray(tensor)
    if arr.shape[0] % g.world_size != 0:
        raise ValueError(
            f"leading dim {arr.shape[0]} not divisible by world size "
            f"{g.world_size}")
    op_id = _advance(g, "reducescatter")
    _post(g.name, "reducescatter", op_id, g.rank, _dumps(arr))
    parts = [_loads(b) for b in
             _collect(g.name, "reducescatter", op_id, g.world_size)]
    full = _REDUCERS[op](np.stack(parts)).astype(arr.dtype)
    return np.array_split(full, g.world_size, axis=0)[g.rank]


def send(tensor: np.ndarray, dst_rank: int,
         group_name: str = "default") -> None:
    """Point-to-point send (reference collective.py:531). Paired with a
    matching recv on dst; (src,dst) channels are ordered by a per-pair
    sequence number."""
    g = _get(group_name)
    seq = g.__dict__.setdefault("_p2p_send", {}).setdefault(dst_rank, 0)
    g.__dict__["_p2p_send"][dst_rank] = seq + 1
    key = f"col/{g.name}/p2p/{g.rank}->{dst_rank}/{seq:08d}".encode()
    _kv().call("kv_put", key, _dumps(np.asarray(tensor)), True, _NS,
               timeout=60.0)


def recv(tensor: np.ndarray, src_rank: int,
         group_name: str = "default") -> np.ndarray:
    """reference collective.py:594."""
    g = _get(group_name)
    seq = g.__dict__.setdefault("_p2p_recv", {}).setdefault(src_rank, 0)
    g.__dict__["_p2p_recv"][src_rank] = seq + 1
    key = f"col/{g.name}/p2p/{src_rank}->{g.rank}/{seq:08d}".encode()
    kv = _kv()
    deadline = time.monotonic() + 120.0
    while True:
        v = kv.call("kv_get", key, _NS, timeout=60.0)
        if v is not None:
            kv.call("kv_del", key, _NS, timeout=30.0)
            result = _loads(v)
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"recv from rank {src_rank} timed out")
        time.sleep(0.002)
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable \
            and tensor.shape == result.shape:
        tensor[...] = result
    return result


def _dumps(arr: np.ndarray) -> bytes:
    return pickle.dumps(arr, protocol=pickle.HIGHEST_PROTOCOL)


def _loads(b: bytes) -> np.ndarray:
    return pickle.loads(b)
