"""Partition-spec check of a parameter tree against a mesh: the errors
of the JAX package's shardlint (ray_tpu/analysis/shardcheck.py
`check_specs`) that its TrainStep.init_state raises on.

- unknown-axis        spec names an axis the mesh does not have
- rank-exceeds-ndim   spec longer than the array's rank
- non-dividing-dim    the axes' size product does not divide the dim
- duplicate-axis      one mesh axis on two dims of the same spec

It runs before any DTensor is built: DTensor takes uneven blocks where
JAX refuses them. The analyser's warnings (a large replicated parameter)
are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .mesh import MESH_AXES, map_specs, spec_axes


def check_spec(spec: Any, shape: tuple, axis_sizes: Dict[str, int],
               where: str = "spec") -> List[str]:
    """The errors of one spec against one array shape, as messages."""
    errors: List[str] = []
    entries = [spec_axes(e) for e in spec]
    if len(entries) > len(shape):
        errors.append(f"{where}: rank-exceeds-ndim: spec {spec} has "
                      f"{len(entries)} entries for a rank-{len(shape)} "
                      f"array of shape {shape}")
        entries = entries[:len(shape)]
    seen: Dict[str, int] = {}
    for dim, axes in enumerate(entries):
        for ax in axes:
            if ax not in axis_sizes:
                errors.append(
                    f"{where}: unknown-axis: spec {spec} names axis {ax!r} "
                    f"which is not in the mesh (axes: "
                    f"{tuple(axis_sizes)}; canonical {MESH_AXES})")
                continue
            if ax in seen:
                errors.append(
                    f"{where}: duplicate-axis: spec {spec} uses mesh axis "
                    f"{ax!r} on both dim {seen[ax]} and dim {dim}")
                continue
            seen[ax] = dim
        group = 1
        for ax in axes:
            group *= axis_sizes.get(ax, 1)
        if group > 1 and shape[dim] % group != 0:
            errors.append(
                f"{where}: non-dividing-dim: dim {dim} of shape {shape} is "
                f"{shape[dim]}, not divisible by the sharding group "
                f"{axes} of size {group}")
    return errors


def check_specs(spec_tree: Any, params: Any, axis_sizes: Dict[str, int],
                where: str = "params") -> None:
    """Raise ValueError naming every parameter whose spec is invalid for a
    mesh of `axis_sizes` (leaves: anything with a `.shape`)."""
    errors: List[str] = []
    map_specs(lambda s, x, path: errors.extend(
        check_spec(s, tuple(x.shape), axis_sizes, where + path)),
        spec_tree, params)
    if errors:
        raise ValueError("invalid param sharding for this mesh:\n"
                         + "\n".join(errors))


__all__ = ["check_spec", "check_specs"]
