"""Multi-slice hybrid meshes: DCN axes across slices, the rest within
(port of ray_tpu/parallel/multislice.py).

A job may span several groups of ranks joined by a slower network (TPU
slices over DCN; GPU hosts over the data-center network, their cards over
NVLink). Data-like axes (dp, pp, an fsdp replica axis) go across the
groups and the bandwidth-hungry ones (tp, sp, ep, in-slice fsdp) within.

- `discover_slice_topology` — which ranks belong to which slice: from
  `num_slices` (contiguous equal slices; the JAX package's
  RAY_TPU_VIRTUAL_SLICES), from per-rank slice ids (e.g. what
  `distributed.rendezvous_slices` assembled; the JAX package reads the
  devices' `slice_index`), else one slice. The JAX package also reads
  MEGASCALE_NUM_SLICES, which the TPU runtime exports; a GPU cluster
  exports nothing like it, and the port reads no environment.
- `HybridMeshConfig` — `MeshConfig` plus DCN axis sizes. `build()`
  block-assembles the rank array (DCN-major on every axis) into a
  `DeviceMesh` named MESH_AXES; `hybrid_rank_array` is that array alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from torch.distributed.device_mesh import DeviceMesh

from .mesh import MESH_AXES, MeshConfig, mesh_rank_array, rank_mesh, \
    solve_axis_sizes

# Mesh axes that may span DCN, mapped to their HybridMeshConfig field.
DCN_AXES: Dict[str, str] = {"dp": "dcn_dp", "fsdp": "dcn_fsdp",
                            "pp": "dcn_pp"}


@dataclass(frozen=True)
class SliceTopology:
    """Slice membership of a rank set. `slices[i]` is the rank list of
    slice i in DCN order; every slice has the same rank count."""

    slices: Tuple[Tuple[int, ...], ...]
    source: str  # "virtual" | "slice_index" | "single"

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def devices_per_slice(self) -> int:
        return len(self.slices[0]) if self.slices else 0

    @property
    def devices(self) -> List[int]:
        return [d for s in self.slices for d in s]

    def describe(self) -> Dict[str, Any]:
        return {"num_slices": self.num_slices,
                "devices_per_slice": self.devices_per_slice,
                "source": self.source}


def _partition(ranks: Sequence[int], k: int, source: str) -> SliceTopology:
    n = len(ranks)
    if k <= 0:
        raise ValueError(f"slice count must be positive, got {k}")
    if n % k != 0:
        raise ValueError(
            f"{n} devices do not partition into {k} equal slices")
    per = n // k
    return SliceTopology(
        slices=tuple(tuple(ranks[i * per:(i + 1) * per])
                     for i in range(k)),
        source=source)


def discover_slice_topology(ranks: Sequence[int], *,
                            num_slices: Optional[int] = None,
                            slice_ids: Optional[Sequence[int]] = None
                            ) -> SliceTopology:
    """Slice count and membership of `ranks`.

    Priority: `num_slices` (contiguous equal slices) > `slice_ids` (one
    per rank, aligned with `ranks`) > one slice. Ranks within a slice
    keep their given order; slices are ordered by slice id (or by
    position for the contiguous partitions)."""
    ranks = [int(r) for r in ranks]
    if num_slices:
        return _partition(ranks, int(num_slices), "virtual")
    if slice_ids is not None:
        if len(slice_ids) != len(ranks):
            raise ValueError(f"{len(slice_ids)} slice ids for "
                             f"{len(ranks)} ranks")
        by_slice: Dict[int, List[int]] = {}
        for r, s in zip(ranks, slice_ids):
            by_slice.setdefault(int(s), []).append(r)
        sizes = {len(v) for v in by_slice.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"unequal slice sizes from slice_index: "
                f"{ {k: len(v) for k, v in by_slice.items()} }")
        return SliceTopology(
            slices=tuple(tuple(by_slice[k]) for k in sorted(by_slice)),
            source="slice_index" if len(by_slice) > 1 else "single")
    return SliceTopology(slices=(tuple(ranks),), source="single")


@dataclass(frozen=True)
class HybridMeshConfig(MeshConfig):
    """MeshConfig plus DCN axis sizes. The base fields size the mesh
    WITHIN one slice (same -1 fill convention, solved against the
    per-slice rank count); dcn_* size the slice grid (at most one may be
    -1 to fill with the remaining slices). The final mesh axis `a` has
    size dcn_a * ici_a, DCN-major."""

    dcn_dp: int = 1
    dcn_fsdp: int = 1
    dcn_pp: int = 1

    def dcn_sizes(self, num_slices: int) -> Dict[str, int]:
        vals = {axis: getattr(self, f) for axis, f in DCN_AXES.items()}
        try:
            solved = solve_axis_sizes(vals, num_slices, "slice")
        except ValueError as e:
            raise ValueError(f"DCN axes: {e}") from None
        return {a: solved.get(a, 1) for a in MESH_AXES}

    def build(self, ranks: Optional[Sequence[int]] = None,
              device: Any = "cuda",
              topology: Optional[SliceTopology] = None) -> DeviceMesh:
        return make_hybrid_mesh(self, ranks=ranks, topology=topology,
                                device=device)


def hybrid_rank_array(config: HybridMeshConfig,
                      ranks: Optional[Sequence[int]] = None,
                      topology: Optional[SliceTopology] = None
                      ) -> np.ndarray:
    """The DCN x ICI rank array of `config` (the JAX package's device
    array with ranks for devices).

    One slice: the hybrid request collapses onto one flat mesh with the
    same axis sizes, so programs written for the hybrid layout run
    unchanged."""
    if topology is None:
        if ranks is None:
            raise ValueError("pass the ranks or a SliceTopology")
        topology = discover_slice_topology(ranks)
    elif ranks is not None and set(topology.devices) != set(ranks):
        raise ValueError(
            "topology does not cover the given devices: the explicit "
            "SliceTopology must be built from exactly the same device "
            "set")
    ranks = topology.devices

    if topology.num_slices == 1:
        ici = config.sizes(len(ranks) // _dcn_product(config))
        dcn = {a: getattr(config, DCN_AXES[a], 1) if a in DCN_AXES else 1
               for a in MESH_AXES}
        merged = MeshConfig(**{a: ici[a] * max(1, dcn[a])
                               for a in MESH_AXES})
        return mesh_rank_array(merged, ranks)

    ici = config.sizes(topology.devices_per_slice)
    dcn = config.dcn_sizes(topology.num_slices)
    return _assemble_hybrid(topology, tuple(ici[a] for a in MESH_AXES),
                            tuple(dcn[a] for a in MESH_AXES))


def make_hybrid_mesh(config: HybridMeshConfig,
                     ranks: Optional[Sequence[int]] = None,
                     topology: Optional[SliceTopology] = None,
                     device: Any = "cuda") -> DeviceMesh:
    """The DCN x ICI hybrid `DeviceMesh` of `config` over `ranks` (default
    with no topology: every rank of the default process group, one
    slice)."""
    if ranks is None and topology is None:
        import torch.distributed as dist

        ranks = range(dist.get_world_size())
    return rank_mesh(hybrid_rank_array(config, ranks, topology), device)


def dcn_axis_factors(config: MeshConfig, n_devices: int,
                     num_slices: int) -> Dict[str, int]:
    """Per-axis DCN span of `config` laid out over `num_slices` equal
    slices: factor d means a line along that mesh axis touches d distinct
    slices. Hybrid configs get their declared dcn_* sizes; a FLAT
    MeshConfig stretched across slices gets a count on its row-major
    layout — how tp/sp/ep silently spanning DCN is caught."""
    if num_slices <= 1:
        return {a: 1 for a in MESH_AXES}
    if isinstance(config, HybridMeshConfig):
        return config.dcn_sizes(num_slices)
    sizes = config.sizes(n_devices)
    per_slice = n_devices // num_slices
    shape = tuple(sizes[a] for a in MESH_AXES)
    slice_ids = (np.arange(n_devices) // per_slice).reshape(shape)
    factors: Dict[str, int] = {}
    for i, a in enumerate(MESH_AXES):
        if shape[i] <= 1:
            factors[a] = 1
            continue
        lines = np.moveaxis(slice_ids, i, -1).reshape(-1, shape[i])
        factors[a] = int(max(len(set(line)) for line in lines))
    return factors


def _dcn_product(config: HybridMeshConfig) -> int:
    p = 1
    for f in DCN_AXES.values():
        v = getattr(config, f)
        p *= v if v > 0 else 1
    return max(1, p)


def _assemble_hybrid(topology: SliceTopology,
                     ici_shape: Tuple[int, ...],
                     dcn_shape: Tuple[int, ...]) -> np.ndarray:
    """Each slice becomes one ICI-shaped block (row-major), placed at its
    DCN grid coordinate (DCN-major on every axis)."""
    final_shape = tuple(d * i for d, i in zip(dcn_shape, ici_shape))
    slice_grid = np.arange(topology.num_slices).reshape(dcn_shape)
    full = np.empty(final_shape, dtype=np.int64)
    for coord in np.ndindex(*dcn_shape):
        block = np.asarray(topology.slices[int(slice_grid[coord])],
                           dtype=np.int64).reshape(ici_shape)
        full[tuple(slice(c * i, (c + 1) * i)
                   for c, i in zip(coord, ici_shape))] = block
    return full


__all__ = [
    "DCN_AXES",
    "HybridMeshConfig",
    "SliceTopology",
    "dcn_axis_factors",
    "discover_slice_topology",
    "hybrid_rank_array",
    "make_hybrid_mesh",
]
