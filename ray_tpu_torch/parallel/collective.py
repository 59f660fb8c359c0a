"""Host-level collective groups on numpy arrays (port of
ray_tpu/parallel/collective.py, the API of ray.util.collective).

Tensors on the card move inside the step (the mesh's NCCL groups, see
`mesh.py`); this API is for small host-side payloads: metrics, eval
aggregates, rendezvous data. Each `group_name` is an independent gloo
group over a prefix of a key-value store the caller passes (by default
the store of the default process group, e.g. the one
`distributed.initialize_torch_distributed` formed). Every rank of a group
makes the same sequence of calls; arrays must have the same shape and
dtype on every rank. numpy in, numpy out: where the JAX package writes a
result into its input array, so does the port.

The actor side (`create_collective_group`, `CollectiveActorMixin`) waits
for a port of the actor runtime.
"""
from __future__ import annotations

import datetime
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


@dataclass
class _Group:
    name: str
    world_size: int
    rank: int
    pg: Any


_groups: Dict[str, _Group] = {}
# inits per group name in this process: a re-created group rendezvouses
# under a fresh prefix, never on the keys of the one it replaces
_incarnations: Dict[str, int] = {}
_groups_lock = threading.Lock()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "gloo",
                          group_name: str = "default",
                          store: Optional[Any] = None,
                          timeout: float = 300.0) -> None:
    """Join `group_name` as `rank` of `world_size`. Blocks until every
    rank has joined."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if backend != "gloo":
        raise ValueError(f"host collectives run on gloo, not {backend!r}")
    if store is None:
        if not dist.is_initialized():
            raise RuntimeError("pass a store, or initialize the default "
                               "process group first")
        store = dist.distributed_c10d._get_default_store()
    with _groups_lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
        n = _incarnations.get(group_name, 0)
        _incarnations[group_name] = n + 1
    pg = dist.ProcessGroupGloo(
        dist.PrefixStore(f"collective/{group_name}/{n}", store), rank,
        world_size, datetime.timedelta(seconds=timeout))
    with _groups_lock:
        _groups[group_name] = _Group(group_name, world_size, rank, pg)


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        _groups.pop(group_name, None)


def is_group_initialized(group_name: str = "default") -> bool:
    with _groups_lock:
        return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def _group(group_name: str) -> _Group:
    with _groups_lock:
        g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(f"collective group {group_name!r} not initialized "
                           "in this process")
    return g


def _buffer(tensor) -> torch.Tensor:
    """A torch copy of `tensor` (the input array is never a scratch
    buffer)."""
    return torch.from_numpy(np.array(tensor, copy=True))


def _write_back(tensor, out: np.ndarray) -> np.ndarray:
    try:
        np.copyto(tensor, out)
    except (TypeError, ValueError):  # not an array, or another shape
        pass
    return out


def allreduce(tensor, group_name: str = "default",
              op: str = ReduceOp.SUM) -> np.ndarray:
    """Returns the reduced array (written into `tensor` too)."""
    g = _group(group_name)
    buf = _buffer(tensor)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    g.pg.allreduce([buf], opts).wait()
    return _write_back(tensor, buf.numpy())


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM):
    """The reduced array on dst_rank; `tensor` unchanged elsewhere."""
    g = _group(group_name)
    buf = _buffer(tensor)
    opts = dist.ReduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    opts.rootRank = dst_rank
    g.pg.reduce([buf], opts).wait()
    if g.rank == dst_rank:
        return _write_back(tensor, buf.numpy())
    return tensor


def barrier(group_name: str = "default") -> None:
    _group(group_name).pg.barrier().wait()


def broadcast(tensor, src_rank: int = 0,
              group_name: str = "default") -> np.ndarray:
    """src_rank's array on every rank (written into `tensor` too)."""
    g = _group(group_name)
    buf = _buffer(tensor)
    opts = dist.BroadcastOptions()
    opts.rootRank = src_rank
    g.pg.broadcast([buf], opts).wait()
    return _write_back(tensor, buf.numpy())


def allgather(tensor_list: Optional[list], tensor,
              group_name: str = "default") -> List[np.ndarray]:
    """Every rank's array, in rank order (also written into
    tensor_list)."""
    g = _group(group_name)
    buf = _buffer(tensor)
    outs = [torch.empty_like(buf) for _ in range(g.world_size)]
    g.pg.allgather([outs], [buf]).wait()
    out = [o.numpy() for o in outs]
    if tensor_list is not None:
        tensor_list[:] = out
    return out


def reducescatter(tensor, tensor_list: Optional[list] = None,
                  group_name: str = "default",
                  op: str = ReduceOp.SUM) -> np.ndarray:
    """Reduce a list of world_size arrays and return this rank's reduced
    chunk (copied into `tensor` too). `tensor_list` is this rank's
    contribution (default: `tensor` split into world_size chunks)."""
    g = _group(group_name)
    if tensor_list is None:
        tensor_list = np.array_split(np.asarray(tensor), g.world_size)
    chunks = [np.asarray(t) for t in tensor_list]
    flat = _buffer(np.concatenate([c.ravel() for c in chunks]))
    opts = dist.AllreduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    g.pg.allreduce([flat], opts).wait()
    start = sum(c.size for c in chunks[:g.rank])
    mine = chunks[g.rank]
    out = flat.numpy()[start:start + mine.size].reshape(mine.shape)
    return _write_back(tensor, out)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point; the receiver passes a buffer of the same shape and
    dtype."""
    _group(group_name).pg.send([_buffer(tensor)], dst_rank, 0).wait()


def recv(tensor, src_rank: int, group_name: str = "default") -> np.ndarray:
    """Receive into `tensor` (shape and dtype of what src_rank sends) and
    return it."""
    buf = _buffer(tensor)
    _group(group_name).pg.recv([buf], src_rank, 0).wait()
    return _write_back(tensor, buf.numpy())


__all__ = ["ReduceOp", "allgather", "allreduce", "barrier", "broadcast",
           "destroy_collective_group", "get_collective_group_size",
           "get_rank", "init_collective_group", "is_group_initialized",
           "recv", "reduce", "reducescatter", "send"]
