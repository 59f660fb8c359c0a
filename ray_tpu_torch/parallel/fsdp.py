"""FSDP sharding-rule inference (port of ray_tpu/parallel/fsdp.py):
ZeRO-3 parameter sharding as partition specs on the `fsdp` mesh axis.

Shard each parameter's largest eligible dim on `fsdp`; the mesh form of
`train.step.TrainStep` then stores each parameter and its AdamW moments
as that rank's block, gathers the parameter before use and
reduce-scatters its gradient.
"""
from __future__ import annotations

from typing import Any, Optional

from torch.distributed.device_mesh import DeviceMesh

from ..tree import tree_map
from .mesh import P, map_specs, mesh_sizes, spec_axes, spec_placements, \
    validate_axis_names


def infer_fsdp_specs(params: Any, fsdp_size: int, *,
                     base_specs: Optional[Any] = None,
                     axis_name: str = "fsdp",
                     min_size_to_shard: int = 2 ** 16) -> Any:
    """Partition-spec tree sharding each param's largest free dim on
    `axis_name`.

    base_specs: existing spec tree (e.g. tp shardings from the model) to
    compose with — fsdp takes the largest dim not already sharded and
    divisible by fsdp_size. Leaves smaller than `min_size_to_shard`
    elements stay replicated (gather cost would beat the memory win).
    Leaves are anything with a `.shape` (tensors, numpy arrays).
    """
    if base_specs is None:
        base_specs = tree_map(lambda x: P(*([None] * len(x.shape))), params)

    def leaf_spec(spec: P, x: Any, _path: str) -> P:
        shape = tuple(x.shape)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        size = 1
        for d in shape:
            size *= d
        if fsdp_size <= 1 or size < min_size_to_shard:
            return P(*spec)
        # a spec may use each mesh axis at most once
        used = {a for s in spec for a in spec_axes(s)}
        if axis_name in used:
            return P(*spec)
        cand = [i for i, (dim, s) in enumerate(zip(shape, spec))
                if s is None and dim % fsdp_size == 0]
        if not cand:
            return P(*spec)
        best = max(cand, key=lambda i: shape[i])
        new = list(spec)
        new[best] = axis_name
        return P(*new)

    return map_specs(leaf_spec, base_specs, params)


def fsdp_shardings(mesh: DeviceMesh, params: Any, **kw) -> Any:
    """DTensor placements for each leaf of `params` on `mesh` (see
    infer_fsdp_specs)."""
    axis = kw.get("axis_name", "fsdp")
    validate_axis_names(mesh, P(axis), "fsdp_shardings axis_name")
    specs = infer_fsdp_specs(params, mesh_sizes(mesh).get(axis, 1), **kw)
    return map_specs(lambda s, _x, _p: spec_placements(mesh, s), specs,
                     params)


__all__ = ["infer_fsdp_specs", "fsdp_shardings"]
