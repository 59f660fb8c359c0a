"""ray_tpu_torch.parallel: the mesh layer of the port (port of
ray_tpu/parallel/).

- MeshConfig / make_mesh: named-axis `DeviceMesh` (dp/fsdp/pp/sp/ep/tp)
  over the ranks of the default process group; `P` partition specs and
  their DTensor placements; `shard_map` with the axis collectives
  (`psum`, `all_gather`, `ppermute`, `all_to_all`, `axis_index`,
  `axis_size`); `RowSplit` / `row_split`: the mesh TrainStep's split
  of the batch rows, for a loss that needs the whole batch
- infer_fsdp_specs / fsdp_shardings: ZeRO-3 specs on the `fsdp` axis
- HybridMeshConfig / make_hybrid_mesh / discover_slice_topology:
  DCN x ICI hybrid meshes over ranks grouped into slices
- distributed: KV rendezvous into one `torch.distributed` job
- collective: host-level collective groups on numpy arrays (gloo)
- pipeline: GPipe over the `pp` axis
- gang: a function run on N local CPU ranks over gloo (the multi-rank
  check on a machine with one card or none)

The actor side of the JAX package's collective API
(`create_collective_group`, `CollectiveActorMixin`) is not ported yet.
"""
from .fsdp import fsdp_shardings, infer_fsdp_specs  # noqa: F401
from .pipeline import (  # noqa: F401
    make_pipeline_fn,
    pipeline_apply,
    stack_stage_params,
)
from .mesh import (  # noqa: F401
    MESH_AXES,
    MeshConfig,
    P,
    RowSplit,
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    host_local_array_to_global,
    make_mesh,
    named_sharding,
    ppermute,
    psum,
    row_split,
    shard_map,
    split_rows,
)
from .multislice import (  # noqa: F401
    HybridMeshConfig,
    SliceTopology,
    discover_slice_topology,
    make_hybrid_mesh,
)
from .collective import (  # noqa: F401
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_rank,
    get_collective_group_size,
    init_collective_group,
    recv,
    reduce,
    reducescatter,
    send,
)
