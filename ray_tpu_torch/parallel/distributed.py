"""Multi-host rendezvous into one `torch.distributed` job (port of
ray_tpu/parallel/distributed.py).

Rank 0 picks a free port on its host and publishes `host:port` under a
group key in a key-value store; the other ranks poll the key, and every
rank then joins `torch.distributed.init_process_group` at that address.
Before that, ranks rendezvous their slice membership (`rendezvous_slices`)
so that ranks of one slice take contiguous process ids.

The key-value store is the caller's: `kv_put(key, value, namespace=)` and
`kv_get(key, namespace=)` on bytes. Inside a `TorchTrainer(mode=
"workers")` gang, `setup_torch_distributed()` runs it over the cluster
conductor's KV with the session's group key, rank and world size.
"""
from __future__ import annotations

import datetime
import json
import socket
import time
from typing import Any, Callable, Dict, List, Optional

import torch.distributed as dist

from ..device import resolve_device

_NAMESPACE = "_torch_distributed"


def _free_port(host: str) -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _local_ip(peer_host: str = "8.8.8.8", host: Optional[str] = None) -> str:
    """Best-effort address other hosts can reach us on: `host` when given
    (the JAX package's RAY_TPU_NODE_IP), else the source IP of the route
    to `peer_host`. Pass the coordinator's host — gang members must reach
    each other on the network they reach it on."""
    if host:
        return host
    if peer_host in ("127.0.0.1", "localhost", "::1"):
        return "127.0.0.1"
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((peer_host, 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def _poll(kv_get: Callable, key: bytes, deadline: float, what: str) -> bytes:
    sleep = 0.01
    while True:
        got = kv_get(key, namespace=_NAMESPACE)
        if got:
            return got
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(sleep)
        sleep = min(sleep * 2, 0.5)


def rendezvous_coordinator(kv_put: Callable, kv_get: Callable,
                           group_key: str, rank: int,
                           timeout: float = 120.0,
                           host: Optional[str] = None) -> str:
    """Agree on a coordinator address for a worker gang. Rank 0 claims
    it; everyone returns `host:port`."""
    key = f"{group_key}/coordinator".encode()
    if rank == 0:
        addr = f"{_local_ip(host=host)}:{_free_port('0.0.0.0')}"
        kv_put(key, addr.encode(), namespace=_NAMESPACE)
        return addr
    return _poll(kv_get, key, time.monotonic() + timeout,
                 f"no coordinator published for {group_key} within "
                 f"{timeout}s").decode()


# ------------------------------------------------------ slice rendezvous

def rendezvous_slices(kv_put: Callable, kv_get: Callable, group_key: str,
                      rank: int, world: int, slice_id: Optional[int],
                      timeout: float = 120.0
                      ) -> Optional[Dict[int, List[int]]]:
    """Each rank publishes its slice id (or a "none" marker) under the
    group key; rank 0 polls the per-rank keys, assembles the slice map
    {slice_id: sorted ranks}, and publishes it under one assembled key
    that the other ranks poll.

    Slice identity must be all-or-none across the gang: a gang where
    only some ranks have a slice id raises ValueError on EVERY rank
    instead of deadlocking with mismatched process ids. Returns None when
    no rank has a slice id (single-slice gang, no grouping needed)."""
    kv_put(f"{group_key}/slice/{rank}".encode(),
           ("none" if slice_id is None else str(int(slice_id))).encode(),
           namespace=_NAMESPACE)
    assembled_key = f"{group_key}/slice_assembled".encode()
    deadline = time.monotonic() + timeout
    sleep = 0.01

    if rank != 0:
        rec = json.loads(_poll(
            kv_get, assembled_key, deadline,
            f"slice rendezvous for {group_key}: rank 0 did not publish "
            f"the assembled slice map within {timeout}s").decode())
        if "__error__" in rec:
            raise ValueError(rec["__error__"])
        if not rec:
            return None
        return {int(s): rs for s, rs in sorted(rec.items())}

    got: Dict[int, Optional[int]] = {rank: slice_id}
    while len(got) < world:
        for r in range(world):
            if r in got:
                continue
            v = kv_get(f"{group_key}/slice/{r}".encode(),
                       namespace=_NAMESPACE)
            if v:
                s = v.decode()
                got[r] = None if s == "none" else int(s)
        if len(got) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"slice rendezvous for {group_key}: only "
                    f"{len(got)}/{world} ranks published within "
                    f"{timeout}s")
            time.sleep(sleep)
            sleep = min(sleep * 2, 0.5)

    missing = sorted(r for r, s in got.items() if s is None)
    if missing:
        if len(missing) < world:
            msg = (f"inconsistent slice identity in {group_key}: ranks "
                   f"{missing} have no slice id while the rest do — "
                   f"slice identity must be all-or-none across the gang")
            kv_put(assembled_key, json.dumps({"__error__": msg}).encode(),
                   namespace=_NAMESPACE)
            raise ValueError(msg)
        kv_put(assembled_key, b"{}", namespace=_NAMESPACE)
        return None

    slice_map: Dict[int, List[int]] = {}
    for r, s in got.items():
        slice_map.setdefault(s, []).append(r)
    slice_map = {s: sorted(rs) for s, rs in sorted(slice_map.items())}
    kv_put(assembled_key,
           json.dumps({str(s): rs for s, rs in slice_map.items()}).encode(),
           namespace=_NAMESPACE)
    return slice_map


def publish_slice_map(kv_put: Callable, group_key: str,
                      slice_map: Dict[int, List[int]],
                      process_ids: Dict[int, int], world: int) -> None:
    """Write the gang's slice map under `{group_key}/slice_map` (rank 0
    only)."""
    kv_put(f"{group_key}/slice_map".encode(),
           json.dumps({"slices": {str(s): rs
                                  for s, rs in slice_map.items()},
                       "process_ids": {str(r): p
                                       for r, p in process_ids.items()},
                       "world": world}).encode(),
           namespace=_NAMESPACE)


def slice_process_ids(slice_map: Dict[int, List[int]]) -> Dict[int, int]:
    """Slice-major process-id assignment: ranks of the same slice get
    CONTIGUOUS process ids (what `multislice.make_hybrid_mesh`'s
    DCN-outer layout expects), with rank 0's slice first so rank 0 keeps
    process id 0 — it hosts the coordinator."""
    rank0_slice = next(s for s, rs in slice_map.items() if 0 in rs)
    order = sorted(slice_map, key=lambda s: (s != rank0_slice, s))
    pids: Dict[int, int] = {}
    pid = 0
    for s in order:
        for r in sorted(slice_map[s]):
            pids[r] = pid
            pid += 1
    return pids


def initialize_torch_distributed(group_key: str, rank: int, world: int,
                                 kv_put: Callable, kv_get: Callable,
                                 timeout: float = 120.0,
                                 host: Optional[str] = None,
                                 slice_id: Optional[int] = None,
                                 device: Any = "cuda",
                                 ) -> Optional[Dict[str, object]]:
    """Run the slice and coordinator rendezvous, then
    `dist.init_process_group(init_method="tcp://<coordinator>")` with
    this rank's process id: NCCL for device "cuda" (the default; each
    rank's card is the current CUDA device), gloo for "cpu".

    With world == 1 the JAX package starts no service; the port forms a
    one-rank group on an in-memory store all the same, because a
    `DeviceMesh` needs a process group.

    Ranks always rendezvous their slice identity (slice_id may be None):
    it must be all-or-none across the gang. With slice ids, process ids
    are reassigned slice-major and rank 0 publishes the slice map under
    `{group_key}/slice_map`; the slice info dict ({"slice_id", "slices",
    "process_ids"}) is returned, else None. The slice id is the caller's:
    the JAX package reads it from RAY_TPU_SLICE_ID / MEGASCALE_SLICE_ID,
    which a TPU runtime exports and a GPU cluster does not.
    """
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if world <= 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return None
    process_id = rank
    slice_info: Optional[Dict[str, object]] = None
    slice_map = rendezvous_slices(kv_put, kv_get, group_key, rank,
                                  world, slice_id, timeout)
    if slice_map is not None:
        pids = slice_process_ids(slice_map)
        process_id = pids[rank]
        slice_info = {"slice_id": int(slice_id),
                      "slices": {int(s): rs
                                 for s, rs in slice_map.items()},
                      "process_ids": {int(r): p
                                      for r, p in pids.items()}}
        if rank == 0:
            publish_slice_map(kv_put, group_key, slice_map, pids, world)

    coordinator = rendezvous_coordinator(kv_put, kv_get, group_key, rank,
                                         timeout, host=host)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return slice_info


def is_torch_distributed_initialized() -> bool:
    """True once this process joined a default process group."""
    return dist.is_available() and dist.is_initialized()


def setup_torch_distributed(timeout: float = 120.0,
                            host: Optional[str] = None) -> tuple:
    """Inside a `TorchTrainer(mode="workers")` train_fn: rendezvous this
    gang into one torch.distributed job and return (rank, world).

    The trainer calls it before train_fn when
    `ScalingConfig.setup_torch_distributed` (the default); calling it
    again is a no-op. The rendezvous runs over the cluster conductor's KV
    under the session's group key. A rank's device follows its lease: a
    rank whose bundle leased a GPU computes on its CUDA device over NCCL,
    one without on the CPU over gloo; nothing falls back from one to the
    other. `timeout` bounds the rendezvous and is the group's collective
    timeout, so a gang that lost a rank fails instead of hanging. `host`
    is the address the other ranks reach this one on (the JAX package's
    RAY_TPU_NODE_IP); by default the interface that reaches the
    conductor."""
    from .._private import worker as worker_mod
    from ..train.session import get_context

    ctx = get_context()
    if not is_torch_distributed_initialized():
        w = worker_mod.global_worker
        if w is None:
            raise RuntimeError("setup_torch_distributed needs a connected "
                               "ray_tpu_torch worker")

        def kv_put(k, v, namespace):
            return w.conductor.call("kv_put", k, v, True, namespace,
                                    timeout=10.0)

        def kv_get(k, namespace):
            return w.conductor.call("kv_get", k, namespace, timeout=10.0)

        group_key = ctx.dist_key or f"group/{ctx.experiment_name}"
        info = initialize_torch_distributed(
            group_key, ctx.rank, ctx.world_size, kv_put, kv_get,
            timeout=timeout,
            host=host or _local_ip(w.conductor_address[0]),
            slice_id=ctx.slice_id, device=ctx.device)
        if info is not None:
            ctx.slice_map = info["slices"]
    return ctx.rank, ctx.world_size


__all__ = ["initialize_torch_distributed",
           "is_torch_distributed_initialized", "setup_torch_distributed",
           "publish_slice_map", "rendezvous_coordinator",
           "rendezvous_slices", "slice_process_ids"]
