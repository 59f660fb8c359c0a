"""Targets of the weight fabric's multi-rank check: a gang of ranks
(`parallel.gang`, gloo on the CPU) that are also drivers of one cluster
publish a DTensor tree and fetch it again under another layout.

`sharded_roundtrip(rank, world, address)`: each rank joins the cluster
at `address`, lays a tree out on a (dp, fsdp) mesh as the JAX package's
tests/test_weights.py does (rows split over both axes, a column split, a
replicated bias, a plain step), publishes ONLY its own blocks as one
joint version of `world` hosts, then fetches it under a (tp,) layout
(every 2-D leaf split by columns) and checks each local block against
the numpy values, and that no read built more than its own block of a
sharded leaf. The targets live in the package because a spawned rank
imports its target's module.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

NAME = "roundtrip"
VERSION = 11


def tree_values(seed: int = 3) -> Dict[str, np.ndarray]:
    """The tree of tests/test_weights.py `_tree(mesh, seed=3)`."""
    rng = np.random.default_rng(seed)
    return {"w_big": rng.standard_normal((64, 16)).astype(np.float32),
            "w_col": rng.standard_normal((4, 32)).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32),
            "step": np.int32(7)}


def sharded_roundtrip(rank: int, world: int, address: str) -> Dict[str, Any]:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)

    import ray_tpu_torch as rt
    from ray_tpu_torch import weights as wts
    from ray_tpu_torch._private import worker as worker_mod

    vals = tree_values()
    rt.init(address=address)
    try:
        train = init_device_mesh("cpu", (2, world // 2),
                                 mesh_dim_names=("dp", "fsdp"))
        state = {
            "w_big": distribute_tensor(torch.from_numpy(vals["w_big"]),
                                       train, [Shard(0), Shard(0)]),
            "w_col": distribute_tensor(torch.from_numpy(vals["w_col"]),
                                       train, [Shard(1), Shard(1)]),
            "bias": distribute_tensor(torch.from_numpy(vals["bias"]),
                                      train, [Replicate(), Replicate()]),
            "step": torch.tensor(7, dtype=torch.int32)}
        pub = wts.WeightPublisher(NAME)
        assert (pub.host_rank, pub.num_hosts) == (rank, world)
        assert pub.publish(state, step=VERSION) == VERSION
        dist.barrier()  # every fragment is in: the version is committed
        w = worker_mod.global_worker
        manifest = w.conductor.call("weights_get_manifest", NAME, None,
                                    timeout=10.0)
        big = next(lf for lf in manifest["leaves"]
                   if tuple(lf["shape"]) == (64, 16))
        full = 64 * 16 * 4
        out = {"version": manifest["version"],
               "num_hosts": manifest["num_hosts"],
               "big_shards": len(big["shards"]),
               "big_shard_bytes": sorted(s["nbytes"]
                                         for s in big["shards"])}
        tp = init_device_mesh("cpu", (world,), mesh_dim_names=("tp",))
        like = {
            "w_big": distribute_tensor(torch.zeros(64, 16), tp, [Shard(1)]),
            "w_col": distribute_tensor(torch.zeros(4, 32), tp, [Shard(1)]),
            "bias": distribute_tensor(torch.zeros(16), tp, [Replicate()]),
            "step": torch.tensor(0, dtype=torch.int32)}
        sub = wts.WeightSubscriber(NAME)
        got = sub.fetch(like=like)
        for k in ("w_big", "w_col"):
            n = got[k].shape[1] // world
            assert got[k].placements == like[k].placements, k
            np.testing.assert_array_equal(
                got[k].to_local().numpy(),
                vals[k][:, rank * n:(rank + 1) * n])
        np.testing.assert_array_equal(got["bias"].to_local().numpy(),
                                      vals["bias"])
        assert int(got["step"]) == 7
        stats = sub.last_stats
        assert stats.version == VERSION
        for rec in stats.leaf_read_bytes:
            if rec["full_nbytes"] == full:
                assert 0 < rec["max_read_bytes"] <= full // world, rec
        out["big_max_read_bytes"] = max(
            r["max_read_bytes"] for r in stats.leaf_read_bytes
            if r["full_nbytes"] == full)
        sub.close()
        dist.barrier()  # every rank fetched: the chunks may go
        pub.close()
        return out
    finally:
        rt.shutdown()
